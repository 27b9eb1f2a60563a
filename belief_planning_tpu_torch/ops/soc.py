"""Batched second-order-cone projection, with its CUDA kernel (the reference
package's ``ops/pallas_kernels.py``, ``proj_soc_pallas``).

:func:`proj_soc` projects each row ``(t, u)`` of a ``(rows, k)`` array onto
``{‖u‖ ≤ t}``; it is the z-update of the CVaR cone ADMM
(``solvers/cvar.cvar_solve``), one cone per tree stage:

- on a CUDA tensor it launches the hand-written kernel ``csrc/proj_soc.cu``
  (one thread per row), or raises;
- on a CPU tensor it runs ``solvers.cvar._proj_soc_batch``, the plain
  PyTorch version, which the tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from belief_planning_tpu_torch.solvers.cvar import _proj_soc_batch
from belief_planning_tpu_torch.utils.nvcc import build_shared_library

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "proj_soc.cu"


class SOCProjectionKernel:
    """Wrapper of ``csrc/proj_soc.cu`` (replaces the reference's
    ``proj_soc_pallas``). ``launches`` counts the kernel launches, and
    nothing else; ``build_log`` / ``build_seconds`` are what nvcc printed and
    took when this process built the library."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None

    def load(self):
        """Build (nvcc, at first use) and load the kernel library."""
        if self._lib is None:
            path, self.build_log, self.build_seconds = build_shared_library(KERNEL_SOURCE)
            lib = ctypes.CDLL(str(path))
            for name in ("bp_proj_soc_f32", "bp_proj_soc_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.bp_proj_soc_max_k.argtypes = []
            lib.bp_proj_soc_max_k.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, v):
        """Launch the projection of ``v`` on the current stream; returns the
        output (allocated here)."""
        lib = self.load()
        rows, k = v.shape
        if not 1 <= k <= lib.bp_proj_soc_max_k():
            raise ValueError(f"proj_soc: rows of length {k}; the kernel takes 1 to "
                             f"{lib.bp_proj_soc_max_k()}")
        out = torch.empty_like(v)
        fn = lib.bp_proj_soc_f64 if v.dtype == torch.float64 else lib.bp_proj_soc_f32
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                     ctypes.c_longlong(rows), ctypes.c_int(k), ctypes.c_int(v.device.index),
                     ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"proj_soc launch failed: CUDA error {err}")
        self.launches += 1
        return out


KERNEL = SOCProjectionKernel()


def proj_soc(v):
    """Project the rows of ``v (rows, k)`` onto the SOC {(t, u): ‖u‖ ≤ t},
    ``t = v[:, 0]``. CUDA tensors (contiguous, f32 or f64, at least one row)
    launch the kernel; CPU tensors run the plain version."""
    if not v.is_cuda:
        return _proj_soc_batch(v)
    if (v.dim() != 2 or v.shape[0] < 1 or v.dtype not in (torch.float32, torch.float64)
            or not v.is_contiguous()):
        raise ValueError(f"proj_soc: needs a contiguous float32/float64 (rows ≥ 1, k) tensor, "
                         f"got {tuple(v.shape)} {v.dtype} contiguous={v.is_contiguous()}")
    return KERNEL.launch(v)
