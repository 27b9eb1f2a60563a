"""Tree engine: batched scenario/trajectory-tree construction (the reference
package's ``tree/engine.py``).

Every array carries a leading batch axis over independent trees (the JAX
package vmaps a single-tree build; here the batch is written out). The tree
is expanded level by level: branch probabilities and obstacle rollouts for all
branches of a level at once, then one linearization over all nodes and one
collision-row evaluation over all constrained nodes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from belief_planning_tpu_torch.models.policies import lanes_over
from belief_planning_tpu_torch.ops.rollout import rollout_controls
from belief_planning_tpu_torch.tree.topology import TreeTopology


class TreeState(NamedTuple):
    """Node-major arrays of a batch of built trees (leading batch axis)."""

    x_lin: Any   # (Bt, totalx, n) linearization trajectory (terminal filled)
    u_lin: Any   # (Bt, totalu, d) warm-start input trajectory
    z: Any       # (Bt, totalu, n) obstacle state at each constrained node
    p: Any       # (Bt, nbr, m) branch probabilities (leaves: zeros)
    dp: Any      # (Bt, nbr, m, n) ∂p/∂x (leaves: zeros)
    w: Any       # (Bt, nbr) branch weights
    A: Any       # (Bt, totalx, n, n) dynamics into node i (row 0: 0)
    Bm: Any      # (Bt, totalx, n, d)
    C: Any       # (Bt, totalx, n)
    h0: Any      # (Bt, totalu) linearized collision offset h − dh·x_lin
    dh: Any      # (Bt, totalu, n) collision gradient


def warm_shift_indices(topo: TreeTopology, p_prev):
    """Per-stage source indices of the warm-start shift, ``(Bt, totalu)``:
    within each branch shift left by one; the freed last slot takes the
    argmax-probability child's first stage (non-leaf) or repeats itself
    (leaf). ``argmax`` takes the first maximum, as in the reference."""
    dev = p_prev.device
    steps = torch.as_tensor(topo.unode_step, device=dev)
    branch = torch.as_tensor(topo.unode_branch, dtype=torch.long, device=dev)
    blen = torch.as_tensor(topo.blen, device=dev)[branch]
    is_leaf = torch.as_tensor(topo.is_leaf, device=dev)[branch]
    child_first_u = torch.as_tensor(topo.u_off[np.maximum(topo.children, 0)],
                                    dtype=torch.long, device=dev)        # (nbr, m)
    best_child = torch.argmax(p_prev, dim=-1)                            # (Bt, nbr)
    src_nonleaf = torch.gather(child_first_u.expand(p_prev.shape[0], -1, -1), 2,
                               best_child[..., None])[..., 0]            # (Bt, nbr)
    idx = torch.arange(topo.totalu, device=dev)
    last = steps == blen - 1
    src = torch.where(last, torch.where(is_leaf, idx, src_nonleaf[:, branch]),
                      torch.clamp(idx + 1, max=topo.totalu - 1))
    return src


def shift_warm_start(topo: TreeTopology, u_prev, p_prev):
    """Warm-start input shift (see :func:`warm_shift_indices`)."""
    src = warm_shift_indices(topo, p_prev)
    return torch.gather(u_prev, 1, src[..., None].expand(-1, -1, u_prev.shape[-1]))


def build_tree(model, topo: TreeTopology, x, z, u_lin, policy_params, lanes=None) -> TreeState:
    """Build the trees from measured states ``x, z (Bt, n)`` and warm-start
    inputs ``u_lin (Bt, totalu, d)`` (zeros on the first solve). ``lanes``
    (``policies.lane_flags``) marks the policy-param leaves that carry a
    leading tree axis, one value a tree."""
    Bt = x.shape[0]
    dtype, dev = x.dtype, x.device
    n, d, N, m = topo.n, topo.d, topo.N, topo.m
    nbr = topo.n_branches

    x_lin = x.new_zeros((Bt, topo.totalx, n))
    znodes = x.new_zeros((Bt, topo.totalu, n))
    p_all = x.new_zeros((Bt, nbr, m))
    dp_all = x.new_zeros((Bt, nbr, m, n))
    w_all = x.new_zeros((Bt, nbr))
    w_all[:, 0] = 1.0
    x_last = x.new_zeros((Bt, nbr, n))
    z_last = x.new_zeros((Bt, nbr, n))
    x_last[:, 0] = x
    z_last[:, 0] = z
    x_lin[:, 0] = x
    znodes[:, 0] = z

    u_off = np.asarray(topo.u_off)
    x_off = np.asarray(topo.x_off)
    blen = np.asarray(topo.blen)

    for k in range(topo.NB):
        lo, hi = topo.level_lo[k], topo.level_hi[k]
        nb = hi - lo
        clo, chi = topo.level_lo[k + 1], topo.level_hi[k + 1]

        xl = x_last[:, lo:hi]
        zl = z_last[:, lo:hi]
        p, dp = model.branch_eval(xl, zl, policy_params, lanes)       # (Bt,nb,m), (Bt,nb,m,n)
        zp = model.zpred(zl, lanes_over(policy_params, lanes, zl.shape[:-1]))  # (Bt,nb,m,N,n)
        p_all[:, lo:hi] = p
        dp_all[:, lo:hi] = dp
        w_all[:, clo:chi] = (w_all[:, lo:hi, None] * p).reshape(Bt, nb * m)

        # parent's last (state, input) propagated into each child's first state
        u_last_idx = u_off[lo:hi] + blen[lo:hi] - 1
        xp = model.step(xl, u_lin[:, u_last_idx])              # (Bt, nb, n)
        x0c = torch.repeat_interleave(xp, m, dim=1)            # (Bt, nb*m, n)

        cui = u_off[clo:chi][:, None] + np.arange(N)[None, :]  # (nb*m, N)
        u_seq = u_lin[:, cui]                                  # (Bt, nb*m, N, d)
        xs_rest = rollout_controls(model.dyn, x0c, u_seq[:, :, :N - 1], model.dt)
        xtraj_c = torch.cat([x0c[:, :, None], xs_rest], dim=2)  # (Bt, nb*m, N, n)

        cxi = x_off[clo:chi][:, None] + np.arange(N)[None, :]
        x_lin[:, cxi] = xtraj_c
        z_children = zp.reshape(Bt, nb * m, N, n)
        znodes[:, cui] = z_children
        x_last[:, clo:chi] = xtraj_c[:, :, -1]
        z_last[:, clo:chi] = z_children[:, :, -1]

    # leaf terminal nodes: the propagated state (diagnostic only)
    leaf_ids = np.nonzero(np.asarray(topo.is_leaf))[0]
    lu = u_off[leaf_ids] + blen[leaf_ids] - 1
    term_idx = x_off[leaf_ids] + blen[leaf_ids]
    x_lin[:, term_idx] = model.step(x_last[:, leaf_ids], u_lin[:, lu])

    # one linearization at every node's predecessor
    pred_x = np.asarray(topo.pred_x).copy()
    pred_u = np.asarray(topo.pred_u).copy()
    pred_x[0] = 0
    pred_u[0] = 0
    A, Bm, C, _ = model.linearize(x_lin[:, pred_x], u_lin[:, pred_u])
    A[:, 0] = 0.0
    Bm[:, 0] = 0.0
    C[:, 0] = 0.0

    # collision rows at all constrained nodes
    xc = x_lin[:, np.asarray(topo.cnode_x)]
    h_raw, dh = model.col_raw(xc, znodes)
    h0 = h_raw - torch.sum(dh * xc, dim=-1)

    return TreeState(x_lin=x_lin, u_lin=u_lin, z=znodes, p=p_all, dp=dp_all,
                     w=w_all, A=A, Bm=Bm, C=C, h0=h0, dh=dh)
