"""Per-stage timing, a profiler trace and a structured event log (the
reference package's ``utils/timing.py``).

:class:`StageTimer` accumulates wall-clock time by stage name. CUDA work is
asynchronous: a stage measured without waiting for it measures its launch,
not its execution, so ``stage(name, block_on=t)`` waits for the device of
every CUDA tensor in ``t`` (``torch.cuda.synchronize``) before it stops the
clock. :func:`trace` records a ``torch.profiler`` trace of a region and
writes it as a Chrome trace (open in ``chrome://tracing`` or Perfetto).
:class:`EventLog` is the reference's JSONL event log.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves


def block_until_ready(tree):
    """Wait until the devices of every CUDA tensor in ``tree`` (tensors,
    tuples, named tuples, lists, dicts) have finished their queued work;
    return ``tree``."""
    for dev in {t.device for t in tree_leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class StageTimer:
    """Accumulating wall-clock timer keyed by stage name. Pass the stage's
    last output as ``block_on`` so that its device work is inside the
    stage."""

    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'mean ms':>12}{'total s':>12}"]
        for k, v in sorted(self.summary().items()):
            lines.append(
                f"{k:<24}{v['count']:>8}{v['mean_ms']:>12.3f}{v['total_s']:>12.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of a region (CPU activity, and CUDA activity
    when CUDA is available), written to ``logdir/trace.json`` as a Chrome
    trace. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class EventLog:
    """Structured JSONL event log (metrics / solver health / sim events)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[dict] = []

    def log(self, kind: str, **fields):
        evt = {"t": time.time(), "kind": kind, **fields}
        self.events.append(evt)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(evt, default=float) + "\n")

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]
