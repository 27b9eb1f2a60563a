"""The closed-loop overtake ensemble (the reference package's
``envs/batched_highway.py``): thousands of independent overtake worlds, each
an ego running the branch-MPC controller behind an obstacle, stepped
together.

A world step (:func:`make_env_logic`, written over the whole batch):

- ``pre``: lane bookkeeping for ego and obstacle; when the obstacle's lane
  assignment changes, the ego's lane-change target is retargeted around it;
  the obstacle's random lane intent (every 10 steps, with probability 0.5,
  left or right with probability 0.5; recorded but, as in the reference,
  never applied); the obstacle's input, the backup policy of largest
  safety over its rollouts (the numeric path: clipped vehicle margins,
  lane rows on the ego's maintain branch, the simulator's brake
  constants); the overtake reference ``xRef``;
- the controller step on all worlds, each with its own lane-change target
  (``policy_in_axes``);
- ``post``: an Euler step of both vehicles and the collision flag.

Randomness enters as data: a step takes ``draws (B, 2)``, two uniforms a
world (the lane-intent roll and its side), and ``init_worlds`` the
obstacle's start or a generator for it. The JAX package draws both from a
``jax.random`` key chain, which this package cannot reproduce; its tests
feed the JAX package's draws and worlds to both.

Two couplings share these closures: :func:`make_batched_overtake_fused`,
the main path, one ``make_branch_mpc_batched_step`` call a world step (the
fused IPM iteration, the CUDA kernel on the card), and
:func:`make_batched_overtake`, one ``make_branch_mpc_step`` call (each
tree's IPM in plain PyTorch), its cross-check.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from belief_planning_tpu_torch.controllers.branch_mpc import (
    make_branch_mpc_batched_step,
    make_branch_mpc_step,
)
from belief_planning_tpu_torch.envs.batched_merge import euler
from belief_planning_tpu_torch.models.policies import (
    LaneChangeParams,
    MaintainParams,
    brake,
    brake_params_mpc,
    brake_params_sim,
    cast_params,
    lane_change,
    maintain,
)
from belief_planning_tpu_torch.models.safety import lane_bdry_h, veh_col
from belief_planning_tpu_torch.solvers.tree_qp_ipm import QPIPMConfig
from belief_planning_tpu_torch.utils.device import resolve_device

V0 = 20.0
LANE_W = 3.6
# the controller's policy params: maintain and brake shared, one lane-change
# target a world
POLICY_IN_AXES = (None, None, LaneChangeParams(x_target=0))


class WorldState(NamedTuple):
    """A batch of overtake worlds (leading axis B)."""

    mpc_carry: Any   # the controller's warm start (MPCCarry)
    x: Any           # (B, 4) ego
    z: Any           # (B, 4) obstacle
    ego_lane: Any    # (B,) int64
    obs_lane: Any    # (B,) int64
    obs_des_y: Any   # (B,) the obstacle's desired lane centre
    lc_target: Any   # (B, 4) the ego's lane-change policy target
    collided: Any    # (B,) bool


class PreAux(NamedTuple):
    """What ``pre`` computes for ``post``, besides ``xRef``."""

    ego_lane: Any
    obs_lane: Any
    obs_des_y: Any
    lc_target: Any
    u_obs: Any       # (B, 2) the obstacle's input


class EnvLogic(NamedTuple):
    mk_policy_params: Any   # lc_target (B, 4) → the controller's policy params
    pre: Any                # (worlds, draws (B, 2), t) → (xRef (B, 4), PreAux)
    post: Any               # (worlds, aux, new_carry, u_ego, feasible) → (worlds, out)
    init_worlds: Any        # (z0 (B, 4), mpc_carry) → WorldState


def make_env_logic(cons, model, N_lane: int, dtype, device) -> EnvLogic:
    """The overtake world step's closures over a batch of worlds in
    ``dtype`` on ``device`` (see the module docstring). ``N_lane`` is the
    road's lane count; the obstacle's lane rows bound it."""
    dt = model.dt
    lb_lo, lb_hi = cons.W / 2, N_lane * LANE_W - cons.W / 2
    maint, brake_mpc, brake_sim = cast_params(
        (MaintainParams(Kpsi=cons.Kpsi), brake_params_mpc(cons.Kpsi),
         brake_params_sim(cons.Kpsi)), dtype, device)
    size = (cons.L + 1, cons.W + 0.2)

    def mk_policy_params(lc_target):
        return (maint, brake_mpc, LaneChangeParams(x_target=lc_target))

    def lane_update(state, lane, t):
        newlane = torch.round((state[:, 1] - 1.8) / LANE_W).long()
        cond = (newlane != lane) & (torch.abs(state[:, 1] - 1.8 - LANE_W * newlane.to(dtype)) < 1.4)
        if t == 0:
            cond = torch.ones_like(cond)
        return torch.where(cond, newlane, lane), cond

    def pre(worlds: WorldState, draws, t: int):
        x, z = worlds.x, worlds.z
        ego_lane, _ = lane_update(x, worlds.ego_lane, t)
        obs_lane, obs_changed = lane_update(z, worlds.obs_lane, t)

        # the ego's lane-change target, around the obstacle's new lane
        tgt = torch.where(ego_lane < obs_lane, obs_lane - 1,
                          torch.where(ego_lane > obs_lane, obs_lane + 1,
                                      torch.where(obs_lane > 0, obs_lane - 1, obs_lane + 1)))
        zero = torch.zeros_like(x[:, 0])
        new_lc = torch.stack([zero, 1.8 + LANE_W * tgt.to(dtype), zero + V0, zero], dim=1)
        lc_target = torch.where(obs_changed[:, None], new_lc, worlds.lc_target)
        pp = mk_policy_params(lc_target)

        # the obstacle's lane intent: every 10 steps w.p. 0.5, left or right
        do_lc = draws[:, 0] <= 0.5
        if t % 10 != 0:
            do_lc = torch.zeros_like(do_lc)
        des_mid = torch.where(draws[:, 1] <= 0.5, obs_lane - 1, obs_lane + 1)
        des_lane = torch.where(obs_lane == 0, torch.ones_like(obs_lane),
                               torch.where(obs_lane == N_lane - 1,
                                           torch.full_like(obs_lane, N_lane - 2), des_mid))
        obs_des_y = torch.where(do_lc, 1.8 + LANE_W * des_lane.to(dtype), worlds.obs_des_y)

        # the obstacle's backup: largest safety over its rollouts against the
        # ego's maintain branch (clipped margins, lane rows on the ego branch)
        x1 = model.xpred(x, pp)                                   # (B, N, 4)
        hcol = veh_col(model.zpred(z, pp), x1[:, None], size, clip=5.0)   # (B, m, N)
        hlane = lane_bdry_h(x1, lb_lo, lb_hi)                     # (B, N)
        hi = torch.minimum(hcol.amin(dim=-1), hlane.amin(dim=-1, keepdim=True))
        us = torch.stack([maintain(z, maint), brake(z, brake_sim),
                          lane_change(z, LaneChangeParams(x_target=lc_target))], dim=1)
        u_obs = torch.gather(us, 1, torch.argmax(hi, dim=-1)[:, None, None].expand(-1, 1, 2))[:, 0]

        # the overtake reference
        Ydes = torch.where(x[:, 0] < z[:, 0], 1.8 + LANE_W * ego_lane.to(dtype), z[:, 1])
        done = (torch.abs(x[:, 1] - Ydes) < 1) & (x[:, 0] > z[:, 0] + 3)
        vdes = torch.where(done, zero + V0, z[:, 2] + 1.0 * (z[:, 0] + 1.5 - x[:, 0]))
        xRef = torch.stack([zero, Ydes, vdes, zero], dim=1)
        return xRef, PreAux(ego_lane=ego_lane, obs_lane=obs_lane, obs_des_y=obs_des_y,
                            lc_target=lc_target, u_obs=u_obs)

    def post(worlds: WorldState, aux: PreAux, new_carry, u_ego, feasible):
        x_new = euler(worlds.x, u_ego, dt)
        z_new = euler(worlds.z, aux.u_obs, dt)
        dis = torch.maximum(torch.abs(x_new[:, 0] - z_new[:, 0]) - 4.0,
                            torch.abs(x_new[:, 1] - z_new[:, 1]) - 2.4)
        new = WorldState(mpc_carry=new_carry, x=x_new, z=z_new, ego_lane=aux.ego_lane,
                         obs_lane=aux.obs_lane, obs_des_y=aux.obs_des_y,
                         lc_target=aux.lc_target, collided=worlds.collided | (dis < 0))
        return new, {"x": x_new, "z": z_new, "u": u_ego, "feasible": feasible}

    def init_worlds(z0, mpc_carry):
        B = z0.shape[0]
        t = lambda v: torch.tensor(v, dtype=dtype, device=device).expand(B, 4).clone()
        lanes = torch.zeros(B, dtype=torch.long, device=device)
        return WorldState(mpc_carry=mpc_carry, x=t([0.0, 1.8, V0, 0.0]), z=z0,
                          ego_lane=lanes, obs_lane=lanes + 1, obs_des_y=z0[:, 1].clone(),
                          lc_target=t([0.5, 1.8, 15.0, 0.0]),
                          collided=torch.zeros(B, dtype=torch.bool, device=device))

    return EnvLogic(mk_policy_params=mk_policy_params, pre=pre, post=post,
                    init_worlds=init_worlds)


def draw_obstacles(B, generator):
    """Obstacle starts ``(B, 4)`` (CPU, f64) as the reference draws them:
    ``[12, 5.4, 17, 0] + N(0, 1)·[2, 0.1, 0.5, 0]``."""
    noise = torch.randn((B, 4), generator=generator, dtype=torch.float64)
    return (torch.tensor([12.0, 5.4, 17.0, 0.0], dtype=torch.float64)
            + noise * torch.tensor([2.0, 0.1, 0.5, 0.0], dtype=torch.float64))


def _make_overtake(step_factory, cons, model, params, variant, ipm, N_lane, dtype, device,
                   **step_kwargs):
    dev = resolve_device(device)
    topo, init_carry, mpc_step = step_factory(model, params, variant, ipm=ipm, device=dev,
                                              policy_in_axes=POLICY_IN_AXES, **step_kwargs)
    logic = make_env_logic(cons, model, N_lane, dtype, dev)

    def init_worlds(B, seed=0, generator=None, z0=None):
        if z0 is None:
            g = generator if generator is not None else torch.Generator().manual_seed(seed)
            z0 = draw_obstacles(B, g)
        z0 = torch.as_tensor(z0, dtype=dtype, device=dev)
        return logic.init_worlds(z0, init_carry(z0.shape[0], dtype))

    def step_once(worlds: WorldState, t: int, draws):
        xRef, aux = logic.pre(worlds, draws, t)
        carrys, res = mpc_step(worlds.mpc_carry, worlds.x, worlds.z, xRef,
                               logic.mk_policy_params(aux.lc_target))
        return logic.post(worlds, aux, carrys, res.uPred[:, 0], res.feasible)

    def episode(worlds: WorldState, n_steps: int, seed=0, t0=0, draws=None):
        if draws is None:
            g = torch.Generator().manual_seed(seed)
            draws = torch.rand((n_steps, worlds.x.shape[0], 2), generator=g,
                               dtype=torch.float64)
        draws = torch.as_tensor(draws, device=dev)
        outs = []
        for k in range(n_steps):
            worlds, out = step_once(worlds, t0 + k, draws[k])
            outs.append(out)
        return worlds, {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}

    episode.step_once = step_once
    return topo, init_worlds, episode


def make_batched_overtake_fused(cons, model, params, variant: str = "prox",
                                ipm: QPIPMConfig = QPIPMConfig(), N_lane: int = 4,
                                dtype=torch.float32, device=None, **step_kwargs):
    """The overtake worlds in closed loop, one :func:`make_branch_mpc_batched_step`
    call a world step for the whole batch (the fused IPM iteration: the CUDA
    kernel on the card), each world with its own lane-change target.
    ``step_kwargs`` go to that step (``prep_dtype``, ``refine_f64``, ...).

    ``device``: ``None`` = ``"cuda"``; pass ``"cpu"`` to run on the CPU.
    Returns ``(topo, init_worlds, episode)``:

    - ``init_worlds(B, seed=0, generator=None, z0=None)``: the ego at
      ``[0, 1.8, 20, 0]`` in lane 0, the obstacle in lane 1 at ``z0 (B, 4)``
      or drawn by :func:`draw_obstacles` from ``generator`` (default a
      ``torch.Generator`` seeded with ``seed``);
    - ``episode(worlds, n_steps, seed=0, t0=0, draws=None)``: ``n_steps``
      world steps from step index ``t0`` (the lane intent rolls where the
      index is a multiple of 10), with ``draws (n_steps, B, 2)`` or uniforms
      from a CPU generator seeded with ``seed``; returns ``(worlds, traj)``,
      the leaves of ``traj`` (x, z, u, feasible) ``(B, n_steps, ...)``;
    - ``episode.step_once(worlds, t, draws)``: one world step, returning
      the new worlds and that step's x, z, u and feasible.
    """
    return _make_overtake(make_branch_mpc_batched_step, cons, model, params, variant, ipm,
                          N_lane, dtype, device, **step_kwargs)


def make_batched_overtake(cons, model, params, variant: str = "prox", N_lane: int = 4,
                          dtype=torch.float32, solver: str = "ipm",
                          ipm: QPIPMConfig = QPIPMConfig(), device=None):
    """The same worlds and step as :func:`make_batched_overtake_fused`, each
    tree solved by :func:`make_branch_mpc_step` (``solver="ipm"``; the
    reference's ADMM raises, ROADMAP.md Queue A item 5), with the same
    arguments and API."""
    return _make_overtake(make_branch_mpc_step, cons, model, params, variant, ipm, N_lane,
                          dtype, device, solver=solver)
