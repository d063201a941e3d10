"""The one launch path of every C entry of ``csrc/``, and its recorder.

Each binding (``fused_turn.py``, ``pq_adc.py``, ``flash_attention.py``,
``flash_decode.py``, ``embedding_bag.py``, ``centroid_topk.py``,
``ivf_scan.py``) checks its operands, allocates outputs and scratch, and
calls ``run`` with the entry's name, its launch plan (``tiling.plan_*``:
the kernels the entry launches) and its arguments.  ``run`` launches the
entry on PyTorch's current stream and raises if a launch was refused.

Under ``record_launches()`` it records the plan instead and launches
nothing: tensors on the ``meta`` device then pass the bindings' checks
(shapes and dtypes only), so ``repro_torch.analysis.kernel_budget`` can
drive the ops entries on meta tensors, as the reference's pass drives
its wrappers under ``eval_shape``, with no card and no build.  Outside
the recorder a meta tensor is refused like any other non-CUDA tensor.

Under ``count_costs()`` every call of a binding that hands ``count`` its
work just before ``run`` (rows 1, 2, 8, 9 and 10: the entries the
registry's steps reach), launched or recorded, also adds (entry,
``cost.Cost``) to the yielded list: the shape-only form of
``kernels/cost.py``, so a count taken on ``meta`` tensors and one taken
on the card agree.  The dry-run (``launch.analysis``) reads the
kernels' FLOPs and bytes from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import Cost
from repro_torch.kernels.tiling import Launch


@dataclasses.dataclass(frozen=True)
class Record:
    """One recorded call of a C entry: its name and its launch plan."""

    entry: str
    plan: List[Launch]


_records: Optional[List[Record]] = None
_costs: Optional[List[Tuple[str, Cost]]] = None


@contextlib.contextmanager
def record_launches() -> Iterator[List[Record]]:
    """Record every entry call's plan into the yielded list and launch
    nothing, until the block ends."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer


def recording() -> bool:
    return _records is not None


@contextlib.contextmanager
def count_costs() -> Iterator[List[Tuple[str, Cost]]]:
    """Add (entry, cost) of every ``count``-ed entry call, launched or
    recorded, to the yielded list until the block ends."""
    global _costs
    outer, _costs = _costs, []
    try:
        yield _costs
    finally:
        _costs = outer


def check_device(name: str, t: torch.Tensor) -> None:
    """A kernel operand lies on a CUDA device, or on ``meta`` while
    recording."""
    if t.device.type == "cuda" or (t.device.type == "meta" and recording()):
        return
    raise ValueError(f"{name}: CUDA tensor required, got {t.device}")


def aligned(t: torch.Tensor) -> bool:
    """The tensor's data starts on a 16-byte boundary (a meta tensor has
    no data and passes)."""
    return t.device.type == "meta" or t.data_ptr() % 16 == 0


def count(entry: str, plan: Sequence[Launch], cost: Cost) -> None:
    """A binding's call of ``entry`` about to ``run`` with this launch
    plan: its shape-only work ``cost`` goes to an active
    ``count_costs`` (nothing for an empty plan, which launches
    nothing)."""
    if _costs is not None and plan:
        _costs.append((entry, cost))


def run(entry: str, plan: Sequence[Launch], device: torch.device,
        *args) -> None:
    """Launch C entry ``entry`` of the kernel library with ``args``
    (tensors pass their data pointers, None a null pointer) and the
    current stream; raise if it returns an error.  Under the recorder,
    record ``plan`` instead.  An empty plan launches nothing."""
    if _records is not None:
        _records.append(Record(entry, list(plan)))
        return
    if not plan:
        return
    if device.type != "cuda":
        raise ValueError(f"{entry}: CUDA tensors required, got {device}")
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        err = getattr(_build.lib(), entry)(
            *c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError "
                           f"{err}")


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` arrival counters for the
    current stream of ``device``, for the kernels whose last block to
    arrive finishes the call (``flash_decode``'s bf16 kernel, the folded
    IVF and ADC scans, stage 1's fold); every call of such a kernel
    leaves its counters zeroed.
    Calls on one stream run one after another and may share the buffer,
    calls on two streams may run at once and must not; keeping it saves
    the fill kernel a ``torch.zeros`` per call would launch.  On ``meta``
    (the plan recorder) an empty tensor of that shape."""
    if device.type != "cuda":
        return torch.empty(n, dtype=torch.int32, device=device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=index)
        _counters[key] = buf
    return buf
