"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; only an explicit ``"cpu"`` runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("belief_planning_tpu_torch runs on a CUDA device; none is "
                           "available (pass device='cpu' to run on the CPU)")
    return dev
