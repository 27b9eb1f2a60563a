"""The shared-row contraction probe, with its CUDA kernel (the reference
package's ``scripts/mxu_probe.py``, the ``pallas_call`` at line 92).

For each node and lane, ``inner`` times: ``cur = dx + 1e-9·acc``, ``acc =
Fx @ cur``, with ``Fx (4, 4)`` shared by every lane and ``dx (nodes, 4, B)``
lane-major; the result is the last ``acc``. It is the split form of the
IPM's constraint rows (``solvers/tree_qp_ipm.qp_ipm_solve``'s ``Fx @ x``),
repeated to swamp the launch. Three modes, one per unit the reference probes:

- ``"fma"``: CUDA-core f32 FMAs (the reference's ``vpu``);
- ``"bf16"``: tensor-core ``mma.sync`` with bf16 operands and f32
  accumulation (the reference's ``mxu``, the TPU's default one-pass dot);
- ``"3xtf32"``: three tensor-core TF32 passes over a big + small split of
  each operand, an f32-grade product (the reference's ``mxu_hi``).

:func:`shared_rows` launches the hand-written kernel
``csrc/shared_rows_probe.cu`` on CUDA tensors (or raises) and runs
:func:`shared_rows_plain`, the plain PyTorch version of the same mode, on
CPU tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from belief_planning_tpu_torch.utils.nvcc import build_shared_library

KERNEL_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "shared_rows_probe.cu"
MODES = ("fma", "bf16", "3xtf32")
CHAIN = 1e-9          # the chain's coupling, the reference's 1e-9
N_ROWS = 4            # n = nFx = 4, the shapes the kernel is built for


def _round_tf32(a):
    """Round float32 values to TF32 (10 mantissa bits), to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(a):
    big = _round_tf32(a)
    return big, _round_tf32(a - big)


def _product(Fx, cur, mode):
    """``Fx @ cur`` per node, as ``mode`` forms it: exact in the tensors'
    dtype, with bf16 operands, or as three TF32 passes (both in float32)."""
    ein = lambda F, c: torch.einsum("rk,nkb->nrb", F, c)
    if mode == "fma":
        return ein(Fx, cur)
    dtype = cur.dtype
    F32, c32 = Fx.float(), cur.float()
    if mode == "bf16":
        out = ein(F32.to(torch.bfloat16).float(), c32.to(torch.bfloat16).float())
    else:
        Fb, Fs = _split_tf32(F32)
        cb, cs = _split_tf32(c32)
        out = (ein(Fb, cs) + ein(Fs, cb)) + ein(Fb, cb)
    return out.to(dtype)


def shared_rows_plain(Fx, dx, inner: int, mode: str = "fma", return_cur: bool = False):
    """The plain PyTorch version: ``inner`` chained products of every node.
    ``return_cur`` also returns the last ``cur`` (the operand of the last
    product)."""
    acc = torch.zeros_like(dx)
    cur = dx
    for _ in range(inner):
        cur = dx + CHAIN * acc
        acc = _product(Fx, cur, mode)
    return (acc, cur) if return_cur else acc


class SharedRowsKernel:
    """Wrapper of ``csrc/shared_rows_probe.cu`` (replaces the reference's
    ``mxu_probe`` Pallas kernel). ``launches`` counts the kernel launches per
    mode, and nothing else; ``build_log`` / ``build_seconds`` are what nvcc
    printed and took when this process built the library."""

    def __init__(self):
        self.launches = {m: 0 for m in MODES}
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib = None

    def load(self):
        """Build (nvcc, at first use) and load the kernel library."""
        if self._lib is None:
            path, self.build_log, self.build_seconds = build_shared_library(KERNEL_SOURCE)
            lib = ctypes.CDLL(str(path))
            ptrs = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            lib.bp_shared_rows_f32.argtypes = [ctypes.c_int] + ptrs
            lib.bp_shared_rows_fma_f64.argtypes = ptrs
            lib.bp_shared_rows_f32.restype = lib.bp_shared_rows_fma_f64.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, Fx, dx, inner: int, mode: str, tile: int):
        """Launch on the current stream; returns the output (allocated here)."""
        lib = self.load()
        nodes, _, B = dx.shape
        out = torch.empty_like(dx)
        args = [ctypes.c_void_p(Fx.data_ptr()), ctypes.c_void_p(dx.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), ctypes.c_int(B), ctypes.c_int(nodes),
                ctypes.c_int(inner), ctypes.c_int(tile), ctypes.c_int(dx.device.index)]
        with torch.cuda.device(dx.device):
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            if dx.dtype == torch.float64:
                err = lib.bp_shared_rows_fma_f64(*args, stream)
            else:
                err = lib.bp_shared_rows_f32(ctypes.c_int(MODES.index(mode)), *args, stream)
        if err != 0:
            raise RuntimeError(f"shared_rows ({mode}) launch failed: CUDA error {err}")
        self.launches[mode] += 1
        return out


KERNEL = SharedRowsKernel()


def shared_rows(Fx, dx, inner: int, mode: str = "fma", tile: int = 128):
    """``inner`` chained shared-row products of ``dx (nodes, 4, B)`` with
    ``Fx (4, 4)``. CUDA tensors launch the kernel: float32 in every mode,
    float64 in ``"fma"``; contiguous; ``tile`` lanes a block (a multiple of
    32, at most 512). CPU tensors run the plain version of the mode."""
    if mode not in MODES:
        raise ValueError(f"shared_rows: mode {mode!r} is not one of {MODES}")
    if not dx.is_cuda:
        return shared_rows_plain(Fx, dx, inner, mode)
    ok_dtype = dx.dtype == torch.float32 or (dx.dtype == torch.float64 and mode == "fma")
    if (dx.dim() != 3 or dx.shape[1] != N_ROWS or dx.shape[0] < 1 or dx.shape[2] < 1
            or tuple(Fx.shape) != (N_ROWS, N_ROWS) or not ok_dtype or Fx.dtype != dx.dtype
            or Fx.device != dx.device or not (dx.is_contiguous() and Fx.is_contiguous())
            or inner < 1 or not (32 <= tile <= 512 and tile % 32 == 0)
            or dx.shape[0] > 65535):
        raise ValueError(
            f"shared_rows: needs contiguous Fx (4, 4) and dx (nodes ≤ 65535, 4, B) on one "
            f"device, float32 (or float64 in 'fma'), inner ≥ 1, tile a multiple of 32 in "
            f"[32, 512]; got Fx {tuple(Fx.shape)} {Fx.dtype} {Fx.device}, dx "
            f"{tuple(dx.shape)} {dx.dtype} {dx.device}, inner {inner}, tile {tile}")
    return KERNEL.launch(Fx, dx, inner, mode, tile)
