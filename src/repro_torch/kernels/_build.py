"""Build and load the CUDA kernels of ``csrc/`` (nvcc → shared library → ctypes).

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the repository root, under a
name that carries a hash of the sources, so an edited kernel is never
served from a stale library.  The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds.  The build
runs at first use (``lib()``), inside the process that launches the
kernels; nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C signatures of the entry points (csrc/fused_turn.cu)
SIGNATURES = {
    "fused_scan_ivf_f32": [P, P, P, I, P, I, P, I, I, I, I, I,
                           P, P, P, P, P, P, P],
    "fused_turn_ivf_f32": [P, P, P, P, I, I, I, I, I, I, I,
                           P, P, P, P, P, P, P, P, P, P, P],
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took and what ptxas said (registers, spills)
last_build: Dict[str, object] = {}


def nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, else ``/usr/local/cuda/bin``, else PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/fused_turn.cu`` (once per source hash); return the .so."""
    out = BUILD_DIR / f"libfused_turn_{_digest()}.so"
    if out.is_file():
        last_build.update(seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "fused_turn.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    last_build.update(seconds=time.perf_counter() - t0,
                      log=res.stdout + res.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = so
    return _lib
