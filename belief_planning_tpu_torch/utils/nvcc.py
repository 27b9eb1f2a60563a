"""Build a CUDA source into a shared library with ``nvcc`` at first use.

The library has a plain C interface and is loaded with ``ctypes``; it does
not include PyTorch's headers, so a build takes seconds. Output goes to
``_build/`` inside the package (git-ignored), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is not.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def build_shared_library(source: Path):
    """Compile ``source`` into ``_build/<stem>-<hash>.so`` unless it exists.
    Returns ``(path, log, seconds)``: the compiler's output (ptxas register
    and spill report) and the build's wall seconds, ``("", 0.0)`` when the
    library was already built. Raises on any compiler error."""
    source = Path(source)
    text = source.read_bytes()
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{key}.so"
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source.name}:\n{log}")
    os.replace(tmp, out)
    return out, log, seconds
