"""Checkpoint and resume of closed-loop simulations and controller carries
(the reference package's ``utils/checkpoint.py``).

The whole resumable state (the controller's carry, the agents' states and
backup and lane indices, the beliefs, the generator's state) goes into one
``.npz`` file, under the reference's keys: a carry field ``f`` is
``carry.f``, a ``None`` field ``carry.f__none``, an extra ``k`` is
``extra.k``. The port's ``MPCCarry`` and the reference's have the same
fields, so a file either package writes loads in the other: arrays keep
their dtype and are reshaped to the template's shape (the port's single-tree
controllers carry a leading batch axis of 1, the reference's none).
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from belief_planning_tpu_torch.utils.device import resolve_device


def _numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]):
    if tree is None:
        out[prefix + "__none"] = np.zeros(0)
        return
    if isinstance(tree, (tuple, list)) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _flatten(f"{prefix}.{name}", getattr(tree, name), out)
        return
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}[{i}]", v, out)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}{{{k}}}", v, out)
        return
    out[prefix] = _numpy(tree)


def save_carry(path: str, carry, extra: Dict[str, Any] = None):
    """Serialize a controller carry (any named-tuple tree of tensors or
    arrays) plus extras."""
    out: Dict[str, np.ndarray] = {}
    _flatten("carry", carry, out)
    if extra:
        for k, v in extra.items():
            _flatten(f"extra.{k}", v, out)
    np.savez(path, **out)


def tree_to_device(tree, template, device):
    """The numpy ``tree`` as tensors on ``device``, each in its template
    leaf's dtype (named tuples, tuples and lists walked; ``None`` kept)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_device(getattr(tree, n), getattr(template, n), device)
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_device(v, t, device) for v, t in zip(tree, template))
    dtype = template.dtype if isinstance(template, torch.Tensor) else None
    return torch.as_tensor(np.asarray(tree), device=device, dtype=dtype)


def load_carry(path: str, template, device=None):
    """Restore a carry into the structure of ``template`` (the same
    named-tuple type, as the controller's ``init_carry`` makes it): each
    field in the template's dtype and shape, as a tensor on ``device``
    (``None`` = ``"cuda"``, raises without CUDA; pass ``"cpu"`` for the
    CPU). A template field that is ``None`` stays ``None``. Returns
    ``(carry, extras dict of numpy arrays)``."""
    dev = resolve_device(device)
    data = dict(np.load(path, allow_pickle=False))

    def rebuild(prefix, tmpl):
        if tmpl is None:
            return None
        if hasattr(tmpl, "_fields"):
            return type(tmpl)(*(rebuild(f"{prefix}.{n}", getattr(tmpl, n))
                                for n in tmpl._fields))
        if isinstance(tmpl, (tuple, list)):
            return type(tmpl)(rebuild(f"{prefix}[{i}]", v) for i, v in enumerate(tmpl))
        t = _numpy(tmpl)
        return data[prefix].astype(t.dtype).reshape(t.shape)

    carry = tree_to_device(rebuild("carry", template), template, dev)
    extras = {k[len("extra."):]: v for k, v in data.items() if k.startswith("extra.")}
    return carry, extras


def save_env_state(path: str, env, carry=None):
    """Snapshot a host environment (``HighwayEnv``, ``HighwayMergeEnv``,
    ``QuadEnv``, ``HMMHighwayEnv``): the agents' states, backup and lane
    indices, the beliefs and the generator's state, with the controller's
    carry (default ``env.mpc.carry``)."""
    extra: Dict[str, Any] = {}
    agents = getattr(env, "veh_set", None) or getattr(env, "robot_set", [])
    extra["agent_states"] = np.stack([a.state for a in agents])
    extra["backupidx"] = np.array([a.backupidx for a in agents])
    if hasattr(agents[0], "laneidx"):
        extra["laneidx"] = np.array([a.laneidx for a in agents])
    if hasattr(env, "b"):
        extra["beliefs"] = np.asarray(env.b)
    if hasattr(env, "rng"):
        state = env.rng.bit_generator.state
        extra["rng_state_json"] = np.frombuffer(json.dumps(state).encode(), dtype=np.uint8)
    save_carry(path, carry if carry is not None else env.mpc.carry, extra)


def load_env_state(path: str, env, carry_template):
    """Restore an environment snapshot in place, the controller's carry on
    the controller's device; returns the carry."""
    carry, extra = load_carry(path, carry_template, env.mpc.device)
    agents = getattr(env, "veh_set", None) or getattr(env, "robot_set", [])
    for i, a in enumerate(agents):
        a.state = extra["agent_states"][i].copy()
        a.backupidx = int(extra["backupidx"][i])
        if "laneidx" in extra and hasattr(a, "laneidx"):
            a.laneidx = int(extra["laneidx"][i])
    if "beliefs" in extra and hasattr(env, "b"):
        env.b = extra["beliefs"].copy()
    if "rng_state_json" in extra and hasattr(env, "rng"):
        env.rng.bit_generator.state = json.loads(bytes(extra["rng_state_json"]).decode())
    env.mpc.carry = carry
    return carry
