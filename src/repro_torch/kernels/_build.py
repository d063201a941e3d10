"""Build and load the CUDA kernels of ``csrc/`` (nvcc → shared library → ctypes).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library in
``build/repro_torch/`` at the repository root, under a name that carries
a hash of the sources, so an edited kernel is never served from a stale
library.  The sources have a plain C interface and include no PyTorch
header, which keeps a build to seconds.  The build runs at first use
(``lib()``), inside the process that launches the kernels; nothing is
built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.POINTER(ctypes.c_longlong)
# C signatures of the entry points, the stream last (csrc/fused_turn.cu,
# csrc/pq_adc.cu,
# csrc/flash_attention.cu, csrc/embedding_bag.cu, csrc/flash_decode.cu,
# csrc/centroid_topk.cu, csrc/ivf_scan.cu, csrc/hnsw_search.cu)
SIGNATURES = {
    "fused_scan_ivf": [P, P, P, I, P, I, P, I, I, I, I,
                       I, I, I, P, I, I, I,
                       P, P, P, P, P, P, P, P, P, P, P, P],
    "fused_turn_ivf": [P, P, P, P, I, I, I, I, I, I,
                       I, I, P, I, I, P, I, I, I,
                       P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P],
    "group_amax": [P, I, I, I, I, I, P, P],
    "pq_adc_scan_f32": [P, I, I, P, P, I, P, I, I, I, I,
                        P, P, P, P, P, P, P, P, I, P],
    "fused_scan_pq": [P, P, I, I, P, P, I, P, I, P, P,
                      I, I, I, I, I, I, I, I, I,
                      P, P, P, P, P, P, P, P, P, P, P, I, P],
    "fused_turn_pq": [P, P, P, I, I, P, P, I, P,
                      I, I, I, I, I, I, I, P, I, I, I,
                      P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I,
                      P],
    "flash_attention_f32": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, LL, P],
    "flash_attention_bf16": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, LL,
                             P],
    "embedding_bag_f32": [P, I, P, P, I, I, P, I, P],
    "flash_decode_f32": [P, P, P, P, I, I, I, I, I, I, I, F, P, P, P, P, P],
    "flash_decode_bf16": [P, I, P, P, P, I, I, I, I, I, I, I, F, P, P, P, P,
                          P, P],
    "centroid_topk": [P, P, I, I, I, I, I, P, P, P, P, P, P],
    "ivf_scan": [P, P, I, P, I, P, I, I, I, I, I, P, P, P, P, P, P, P, P],
    "hnsw_search": [P, I, I, P, I, P, I, I, P, P, I, P, P, I, I, I, I, P,
                    I, P, P, P, P],
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took and, per source, ptxas's lines that name
#: each kernel and give its registers and spills
last_build: Dict[str, object] = {}
PTXAS_LINE = re.compile(r"Compiling entry function|Used \d+ registers|spill")


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
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into one library, once per source hash; return the .so."""
    out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if out.is_file():
        last_build.update(seconds=0.0, ptxas={})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs[src.name] = (obj, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    failed = [n for n, (_, proc) in jobs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    tmp = out.with_suffix(f".{tag}")
    res = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(tmp),
                          *(str(obj) for obj, _ in jobs.values())],
                         capture_output=True, text=True)
    for obj, _ in jobs.values():
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    last_build.update(seconds=time.perf_counter() - t0,
                      ptxas={n: [ln.strip() for ln in log.splitlines()
                                 if PTXAS_LINE.search(ln)]
                             for n, log in logs.items()})
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
