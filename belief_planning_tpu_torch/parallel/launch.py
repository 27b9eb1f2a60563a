"""Run one function in several processes joined by ``torch.distributed``.

The JAX package builds a device mesh inside one process and splits work
with ``shard_map``. The port runs one process per rank instead:
:func:`launch` starts ``world_size`` processes with ``torch.multiprocessing``
in "spawn" mode, joins them through a TCP store that it serves itself on
127.0.0.1 (a free port chosen by the operating system, so two launches
never race for one), and calls ``fn(device, *args)`` on every rank after
``init_process_group``. Inside ``fn``, ``parallel.ensemble.make_mesh``
lays the ranks out on named axes.

``fn`` must be importable by module path (a module-level function of a
module, or of a main script run from a file): spawn re-imports it in every
rank, and the caller's main module from its file (a script read from
standard input has none, and :func:`launch` refuses to start there). What each rank returns is moved to the CPU,
pickled and handed back in rank order.

Backend and device are explicit, and nothing is switched quietly:

- ``backend="gloo"`` runs on the CPU or on CUDA tensors (gloo's CUDA
  collectives stage through the host), so several ranks may share one card;
- ``backend="nccl"`` needs a card a rank: NCCL refuses two ranks on one
  device.

A rank that raises, exits or does not finish in time makes :func:`launch`
stop every rank it started and raise.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import sys
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._pytree import tree_map_only

BACKENDS = ("gloo", "nccl")
HOST = "127.0.0.1"


def rank_devices(world_size: int, backend: str, device=None) -> List[torch.device]:
    """Each rank's device. ``device=None``: rank r runs on ``cuda:r`` (a card
    a rank); an explicit device (``"cuda:0"``, ``"cpu"``) is shared by every
    rank. Raises for a backend other than gloo and nccl, for a card that is
    not there, and for NCCL on the CPU or with two ranks on one card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size {world_size}: expected at least 1")
    if device is None:
        devs = [torch.device("cuda", r) for r in range(world_size)]
    else:
        devs = [torch.device(device)] * world_size
    for dv in devs:
        if dv.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("launch: a rank runs on CUDA but no CUDA device is available "
                                   "(pass device='cpu' to run the ranks on the CPU)")
            idx = 0 if dv.index is None else dv.index
            if idx >= torch.cuda.device_count():
                raise RuntimeError(f"launch: {dv} does not exist ({torch.cuda.device_count()} "
                                   "CUDA devices)")
        elif dv.type != "cpu":
            raise ValueError(f"launch: device {dv} is neither a CPU nor a CUDA device")
    if backend == "nccl":
        if any(dv.type != "cuda" for dv in devs):
            raise ValueError("launch: the nccl backend needs a CUDA device a rank")
        if len({dv.index or 0 for dv in devs}) != len(devs):
            raise ValueError("launch: the nccl backend needs a card a rank (NCCL refuses two "
                             "ranks on one device); use backend='gloo' to share a card")
    return devs


def _rank_main(rank, world_size, backend, device, port, timeout_s, fn, args, results):
    """One rank: join the group through the launcher's store, run ``fn``,
    send back ``(rank, "ok", pickled result)`` or ``(rank, "error",
    traceback)`` (before leaving the group, so that the failing rank's
    message is on its way before its peers see it gone)."""
    joined = False
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore(HOST, port, world_size, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=timeout)
        joined = True
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        out = tree_map_only(torch.Tensor, lambda t: t.detach().cpu(), out)
        results.put((rank, "ok", pickle.dumps(out)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if joined:
            dist.destroy_process_group()


def _take(msg, out, errors):
    rank, status, payload = msg
    if status == "ok":
        out[rank] = pickle.loads(payload)
    else:
        errors[rank] = payload


def launch(fn: Callable[..., Any], world_size: int, backend: str = "gloo", device=None,
           args: Sequence = (), timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order.

    ``backend``: ``"gloo"`` or ``"nccl"``; ``device``: see
    :func:`rank_devices` (``None``: rank r on ``cuda:r``). Each rank's
    process group times out after ``timeout_s``, and so does the launch as a
    whole. Raises ``RuntimeError`` with the failing rank's traceback if a
    rank raises or exits before returning; the other ranks are terminated."""
    devs = rank_devices(world_size, backend, device)
    main = sys.modules.get("__main__")
    main_file = getattr(main, "__file__", None)
    if getattr(main, "__spec__", None) is None and main_file and not os.path.exists(main_file):
        raise RuntimeError(f"launch: spawn re-imports the main module from its file, and "
                           f"{main_file!r} is none: run the caller from a file, with -m or -c")
    store = dist.TCPStore(HOST, 0, None, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, str(devs[r]), store.port, timeout_s, fn,
                               tuple(args), results),
                         daemon=True)
             for r in range(world_size)]
    out, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world_size:
            try:
                _take(results.get(timeout=1.0), out, errors)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if errors or dead or time.monotonic() > deadline:
                # a rank failed: take what the others have sent (a rank that
                # fails in a failed peer's collective reports within moments)
                try:
                    while True:
                        _take(results.get(timeout=0.5), out, errors)
                except queue.Empty:
                    pass
                for r in dead:
                    if r not in out:
                        errors.setdefault(r, f"exited with code {procs[r].exitcode} and no "
                                             "result")
                if not errors:
                    errors[-1] = f"the ranks did not finish within {timeout_s} s"
                break
        if not errors:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                errors[-1] = f"ranks exited with codes {bad} after returning"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
    if errors:
        raise RuntimeError("launch: " + "\n".join(
            f"rank {r} of {world_size} ({backend}, {devs[r]}) failed:\n{msg}" if r >= 0 else msg
            for r, msg in sorted(errors.items())))
    return [out[r] for r in range(world_size)]
