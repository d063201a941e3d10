"""Cost analysis of a traced step: FLOPs, bytes, memory, collectives and
roofline terms (``repro/launch/analysis.py``).

The reference reads a compiled XLA program: ``cost_analysis()``,
``memory_analysis()`` and the collectives parsed from its post-SPMD HLO.
The port has no XLA and no HLO, so its HLO parsers (``_shape_bytes``,
``_group_size``, ``split_computations``, ``while_body_names``,
``collective_bytes_in``) have no input here and are not ported.  In
their place:

* **the trace** (``trace_step``): one ``TorchDispatchMode`` over an
  eager step, on the ``meta`` device (shapes, no data: the counterpart
  of ``eval_shape``) or on the card, and the same counts on both.  It
  counts

  - the FLOPs of every product by its input dtype (the formulas of
    ``torch.utils.flop_counter``'s registry);
  - the bytes of every aten op: the sum of its tensor inputs and
    outputs, each at most its storage, views and metadata ops
    (``empty``, ``detach``, ...) counting nothing; an indexed read
    (``index``, ``embedding``, ``gather``, ``index_select``) moves the
    rows it reads (as many bytes as its output) and its indices, an
    indexed write (``index_put_``, ``scatter_``, ``index_add_``, ...)
    reads its indices and values and writes as many bytes as its values,
    not the whole tensor it writes into.  This is eager HBM traffic with
    no reuse in L2 or in fusions: an upper end of what the step moves;
  - every CUDA kernel call through ``kernels.launcher.count_costs``,
    with the FLOPs and bytes of its shape-only formula
    (``kernels/cost.py``: every id real, every cache row filled).  A
    binding is a pybind call, not an aten op, so its work is counted
    there, once: its output's ``empty`` counts nothing;
  - the peak of the bytes the step allocates and still holds, storage
    by storage: each storage is held until it dies (a weak reference to
    the storage itself, so views, autograd's saved tensors and C++'s own
    copies keep it alive), at the size the CUDA caching allocator gives
    its block at most (``block_bytes``: 512-byte rounding, and up to
    1 MiB of a cached block it does not split above 1 MiB).  Some ops
    also hold a workspace while they run, which no output shows; it
    counts for the duration of the op (``_workspace``; the script
    ``op_workspaces.py`` holds these rules to what each op allocates
    inside itself on the card in every registry step at its smoke
    size): ``sort`` twice its keys and int64 indices (a radix sort's
    double buffers); ``_softmax_backward_data`` a copy of the gradient;
    ``logsumexp`` the shifted input and the maxima; a ``sum`` over dims
    twice its input (a global reduction's staging buffer); an
    ``index_put`` its values and 64 bytes an index (sorting the
    indices); ``embedding_dense_backward`` 64 bytes an index.  An op's
    workspace not listed here goes uncounted.

* **collectives** (``collective_bytes_from_specs``): counted from the
  cell's specs by stated rules with the reference's ring formulas
  (``_coll_cost``), since nothing is partitioned here.

``CellCost``, ``Roofline``, ``roofline_terms`` and ``_coll_cost`` keep
the reference's names and formulas.  ``analyze_trace`` takes the place of
``analyze_compiled`` with the same ``trip_count`` / ``calibration``
semantics: with a calibration (per-layer FLOPs, bytes and collective
bytes from 1- and 2-layer traces) the totals are the 1-layer trace's plus
(trip_count - 1) x per layer; without one, an eager trace already counts
every layer and nothing is adjusted.

Constants are the H100 SXM's datasheet figures (per card): dense bf16
989 TFLOP/s on the tensor cores, float32 67 TFLOP/s on the CUDA cores
(TF32 is off in the port), HBM3 3.35 TB/s, NVLink 4 at 450 GB/s a
direction between the 8 cards of a node, and 50 GB/s a card across
nodes (NDR InfiniBand, 400 Gb/s).  The compute term divides each rate
class's FLOPs by its peak (``kernels.cost.RATES``); a collective whose
group is wider than a node is costed at the across-node rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.sharding import entry_axes
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import launcher

# H100 SXM (per card)
PEAK_FLOPS = _cost.BF16_FLOP_PER_S        # dense bf16
HBM_BW = _cost.HBM_BYTES_PER_S            # bytes/s
NVLINK_BW = 450e9                         # bytes/s a direction, in a node
LINK_BW = 50e9                            # bytes/s a card, across nodes
NODE_CARDS = 8

#: the ops that move no data: allocation and metadata
_META_OPS = frozenset({
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "set_", "resize_",
    "alias", "_unsafe_view", "view", "as_strided", "_reshape_alias",
})


#: indexed reads and writes: they touch only the rows they name
_GATHERS = frozenset({"index", "embedding", "gather", "index_select"})
_SCATTERS = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_add", "index_add_", "index_copy",
    "index_copy_", "scatter_reduce", "scatter_reduce_"})


def _coll_cost(kind: str, rbytes: float, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return rbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return rbytes * (g - 1)
    if kind == "all-reduce":
        return rbytes * 2 * (g - 1) / g
    if kind == "all-to-all":
        return rbytes * (g - 1) / g
    return float(rbytes)        # collective-permute


def link_bw(group: int) -> float:
    """The rate a collective over ``group`` cards runs at: NVLink within a
    node, the network across nodes."""
    return NVLINK_BW if group <= NODE_CARDS else LINK_BW


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def rate_class(dtype: torch.dtype) -> str:
    """The FLOP rate class of products of this input dtype."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


@dataclasses.dataclass
class Trace:
    """What one traced step did.  ``flops`` / ``nbytes`` are ints: the
    aten ops' plus the kernels'.  ``kernels`` maps each C entry to its
    calls; ``peak_live`` is the most bytes the step held at once of what
    it allocated."""
    flops: int = 0
    flops_by_rate: Dict[str, int] = dataclasses.field(default_factory=dict)
    nbytes: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live: int = 0
    bytes_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: on the card, with ``dryrun.trace(measure=True)``: the step's
    #: measured temporaries, launches and finiteness, and a second
    #: step's CUDA-event ms
    measured: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add_flops(self, n: int, rate: str) -> None:
        self.flops += n
        self.flops_by_rate[rate] = self.flops_by_rate.get(rate, 0) + n


#: the caching allocator's block sizes: an allocation rounds up to 512
#: bytes, and one above 1 MiB (the large pool) may take a cached block up
#: to 1 MiB larger, which the allocator does not split
_ROUND = 512
_SMALL = 1 << 20


def block_bytes(n: int) -> int:
    """The most bytes the CUDA caching allocator counts for a storage of
    ``n`` bytes (0 for none)."""
    if n == 0:
        return 0
    r = -(-n // _ROUND) * _ROUND
    return r + _SMALL if n > _SMALL else r


def _workspace(name: str, flat_in, flat_out) -> int:
    """The bytes an aten op holds inside itself on the card while it
    runs, which no output shows (see the module docstring)."""
    if not flat_in:
        return 0
    x = flat_in[0]
    if name == "sort":
        return 2 * block_bytes(x.numel() * (x.element_size() + 8))
    if name == "_softmax_backward_data":
        return block_bytes(_tensor_bytes(x))
    if name == "logsumexp":
        return block_bytes(_tensor_bytes(x)) + sum(
            block_bytes(_tensor_bytes(t)) for t in flat_out)
    if name == "sum" and len(flat_in) == 1 and flat_out[0].numel() > 1:
        return 2 * block_bytes(_tensor_bytes(x))
    if name in ("index_put", "index_put_", "_index_put_impl_") \
            and len(flat_in) > 2:
        return (block_bytes(_tensor_bytes(flat_in[-1]))
                + block_bytes(64 * flat_in[1].numel()))
    if name == "embedding_dense_backward" and len(flat_in) > 1:
        return block_bytes(64 * flat_in[1].numel())
    return 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensor_bytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _op_bytes(name: str, flat_in, flat_out) -> int:
    """The bytes an eager op moves (see the module docstring)."""
    if name in _GATHERS and flat_in:
        out = sum(_tensor_bytes(t) for t in flat_out)
        return 2 * out + sum(_tensor_bytes(t) for t in flat_in[1:])
    if name in _SCATTERS and flat_in:
        rest = [_tensor_bytes(t) for t in flat_in[1:]]
        return sum(rest) + max(rest, default=0)
    return sum(_tensor_bytes(t) for t in flat_in + flat_out)


class Counter(TorchDispatchMode):
    """The dispatch mode of ``trace_step`` (see the module docstring)."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        self._live: Dict[int, int] = {}    # storage key -> block bytes
        self._cur = 0
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry

    def _release(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor, inputs) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in inputs:
            return                       # held, or a view of an input
        nb = self._live[key] = block_bytes(st.nbytes())
        self._cur += nb
        self.trace.peak_live = max(self.trace.peak_live, self._cur)
        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tr = self.trace
        packet = func._overloadpacket
        name = packet.__name__
        flat_in = tensor_leaves((args, kwargs))
        flat_out = tensor_leaves(out)
        if packet in self._flops:
            n = int(self._flops[packet](*args, **kwargs, out_val=out))
            if n:
                tr.add_flops(n, rate_class(flat_in[0].dtype))
                tr.flops_by_op[name] = tr.flops_by_op.get(name, 0) + n
        if not func.is_view and name not in _META_OPS:
            nb = _op_bytes(name, flat_in, flat_out)
            tr.nbytes += nb
            tr.bytes_by_op[name] = tr.bytes_by_op.get(name, 0) + nb
        inputs = {_storage_key(t) for t in flat_in}
        for t in flat_out:
            self._hold(t, inputs)
        work = _workspace(name, flat_in, flat_out)
        if work:
            tr.peak_live = max(tr.peak_live, self._cur + work)
        return out


@contextlib.contextmanager
def counting() -> Any:
    """Count everything run inside the block into the yielded ``Trace``
    (aten ops, kernel calls, live bytes)."""
    trace = Trace()
    with launcher.count_costs() as calls, Counter(trace):
        yield trace
    for entry, c in calls:
        trace.kernels[entry] = trace.kernels.get(entry, 0) + 1
        trace.add_flops(c.flops, c.rate)
        trace.nbytes += c.nbytes


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def trace_step(step_fn: Callable, *args) -> Tuple[Any, Trace]:
    """Run ``step_fn(*args)`` once under ``counting``: (its output, the
    trace).  On ``meta`` tensors the CUDA kernels' calls are recorded
    (``launcher.record_launches``), not launched."""
    meta = any(a.device.type == "meta" for a in tensor_leaves(args))
    with (launcher.record_launches() if meta else contextlib.nullcontext()):
        with counting() as trace:
            out = step_fn(*args)
    return out, trace


#: a C entry of ``csrc/`` -> the kernel's row name in ``kernels.ops``
ENTRY_OPS = {"flash_attention_f32": "flash_attention",
             "flash_attention_bf16": "flash_attention",
             "flash_decode_f32": "flash_decode",
             "flash_decode_bf16": "flash_decode",
             "embedding_bag_f32": "embedding_bag"}


def kernel_launches(trace: Trace) -> Dict[str, int]:
    """The trace's kernel calls by ``kernels.ops`` name (rows 8, 9, 10;
    other entries by their own name)."""
    out: Dict[str, int] = {}
    for entry, n in trace.kernels.items():
        name = ENTRY_OPS.get(entry, entry)
        out[name] = out.get(name, 0) + n
    return out


# ---------------------------------------------------------------------------
# per-cell cost and roofline (the reference's records)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellCost:
    """Per-device cost record for one (arch, shape, mesh) cell."""
    flops: float                 # per device, scan-adjusted
    hbm_bytes: float             # per device, scan-adjusted
    coll_bytes: float            # per-device payload, scan-adjusted
    coll_by_kind: Dict[str, float]
    mem_args: float
    mem_temp: float
    mem_output: float
    peak_memory: float
    raw_flops: float             # unadjusted (one layer's trace)
    adjust_note: str = ""
    flops_by_rate: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    coll_by_group: Dict[int, float] = dataclasses.field(
        default_factory=dict)


def analyze_trace(trace: Trace, *, trip_count: int = 1, share: int = 1,
                  calibration: Optional[Tuple[float, float, float]] = None,
                  rates_per_layer: Optional[Dict[str, float]] = None,
                  temp_per_layer: float = 0.0,
                  coll: Optional[Tuple[float, Dict[str, float],
                                       Dict[int, float]]] = None,
                  mem_args: float = 0.0) -> CellCost:
    """Per-device costs from a trace.

    ``share``: the devices that split the traced work evenly (the model
    axis where the parameters or an argument are split over it alone):
    FLOPs and bytes are divided by it.  ``calibration``: (per-layer
    FLOPs, per-layer bytes, per-layer collective bytes) from 1- and
    2-layer traces, with ``rates_per_layer`` (per-layer FLOPs by rate
    class) and ``temp_per_layer``: the totals become the trace's plus
    (trip_count - 1) x per layer.  ``coll``: (bytes, by kind, by group)
    from ``collective_bytes_from_specs``, per device, for the whole step.
    The outputs count in the temporaries (a train step's alias the
    donated parameters): ``mem_output`` is 0."""
    flops, hbm, temp = trace.flops, trace.nbytes, float(trace.peak_live)
    by_rate = dict(trace.flops_by_rate)
    note = "eager trace at full depth"
    if calibration is not None:
        per_flops, per_bytes, _ = calibration
        n = trip_count - 1
        flops, hbm = flops + n * per_flops, hbm + n * per_bytes
        temp += n * temp_per_layer
        for r, f in (rates_per_layer or {}).items():
            by_rate[r] = by_rate.get(r, 0) + n * f
        note = f"calibrated per-layer x{trip_count}"
    coll_b, by_kind, by_group = coll or (0.0, {}, {})
    return CellCost(flops / share, hbm / share, coll_b, dict(by_kind),
                    mem_args, temp, 0.0, mem_args + temp,
                    trace.flops / share, note,
                    {r: f / share for r, f in by_rate.items()},
                    dict(by_group))


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_ratio: float      # MODEL_FLOPS / (chips·FLOPs)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(cost: CellCost, *, chips: int, model_flops: float,
                   links: int = 1) -> Roofline:
    """cost fields are per device; the compute term divides each rate
    class's FLOPs by its peak (all at the bf16 peak where the record has
    no split), the collective term each group's bytes by its link rate
    (all at the across-node rate where it has no split)."""
    if cost.flops_by_rate:
        compute = sum(f / _cost.RATES[r]
                      for r, f in cost.flops_by_rate.items())
    else:
        compute = cost.flops / PEAK_FLOPS
    memory = cost.hbm_bytes / HBM_BW
    if cost.coll_by_group:
        coll = sum(b / (link_bw(g) * links)
                   for g, b in cost.coll_by_group.items())
    else:
        coll = cost.coll_bytes / (LINK_BW * links)
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dom = max(terms, key=terms.get)
    ratio = model_flops / max(chips * cost.flops, 1.0)
    return Roofline(compute, memory, coll, dom, ratio)


# ---------------------------------------------------------------------------
# collectives from the specs
# ---------------------------------------------------------------------------


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    return tuple(a for e in (spec or ()) for a in entry_axes(e))


def split_factor(spec, mesh_shape: Dict[str, int]) -> int:
    """How many parts a leaf under ``spec`` is split into."""
    n = 1
    for a in spec_axes(spec):
        n *= mesh_shape[a]
    return n


class CollectiveTally:
    """Per-device collective bytes by kind and by group size."""

    def __init__(self):
        self.total = 0.0
        self.by_kind: Dict[str, float] = {}
        self.by_group: Dict[int, float] = {}

    def add(self, kind: str, rbytes: float, g: int, times: float = 1
            ) -> None:
        c = _coll_cost(kind, rbytes, g) * times
        if not c:
            return
        self.total += c
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + c
        self.by_group[g] = self.by_group.get(g, 0.0) + c

    def as_tuple(self):
        return self.total, self.by_kind, self.by_group


def collective_bytes_from_specs(*, kind: str, params, data_axes,
                                model_axis: str, mesh_shape: Dict[str, int],
                                remat: bool = False, lm=None,
                                tokens_local: int = 0,
                                batch_local: int = 0, decode: bool = False,
                                cache_split: bool = False,
                                merge_k: int = 0, score_row: int = 0
                                ) -> CollectiveTally:
    """Per-device collective bytes of one step, by these rules:

    * train, each parameter ``(nbytes, spec)``: split over the data axes
      (FSDP), it is all-gathered over the data group in the forward and
      again in each recomputation (``remat``) and in the backward, its
      gradient reduce-scattered; replicated over the data axes, its
      gradient is all-reduced over the data group (the result: the
      device's shard over the model axis);
    * an LM (``lm``: its config) with the model axis > 1 runs
      Megatron's sequence-parallel layout between layers (the
      reference's ``act_spec``): a layer all-gathers its (B, S, d)
      residual over the model axis before attention and before the MLP
      and reduce-scatters after each, in the forward, in a recomputation
      and, mirrored, in the backward; a prefill runs the forward's;
    * a decode step's tensor-parallel layers all-reduce their (B, 1, d)
      outputs (attention and MLP) over the model axis, and a cache whose
      sequence is split over the model axis (``cache_split``) costs a
      partial-softmax reduce a layer: (B, H, d_head + 2) float32;
    * a top-k merge over the model axis's shards (``merge_k``) gathers
      k (value, id) pairs from each, and a brute-force scan over a
      corpus split by rows (``score_row``: its rows) gathers the (B, N)
      score row;
    * serving with replicated parameters and no such split moves
      nothing.

    Sizes are per device; the group of the data axes is their product,
    of the model axis its size."""
    t = CollectiveTally()
    g_dp = 1
    for a in data_axes:
        g_dp *= mesh_shape[a]
    g_tp = mesh_shape[model_axis]
    if kind == "train":
        for nbytes, spec in params:
            axes = spec_axes(spec)
            local = nbytes / split_factor(spec, mesh_shape)
            if any(a in data_axes for a in axes):
                gathered = local * g_dp
                t.add("all-gather", gathered, g_dp, 2 + int(remat))
                t.add("reduce-scatter", local, g_dp)
            else:
                t.add("all-reduce", local, g_dp)
    if lm is not None and g_tp > 1:
        esize = torch.empty((), dtype=lm.dtype).element_size()
        if decode:
            act = batch_local * lm.d_model * esize
            t.add("all-reduce", act, g_tp, 2 * lm.n_layers)
            if cache_split:
                soft = batch_local * lm.n_heads * (lm.d_head + 2) * 4
                t.add("all-reduce", soft, g_tp, lm.n_layers)
        else:
            act = tokens_local * lm.d_model * esize
            passes = 1 if kind != "train" else 2 + int(remat)
            t.add("all-gather", act, g_tp, 2 * lm.n_layers * passes)
            t.add("reduce-scatter", act / g_tp, g_tp,
                  2 * lm.n_layers * passes)
    if merge_k:
        t.add("all-gather", merge_k * 8 * g_tp, g_tp)
    if score_row:
        t.add("all-gather", score_row * 4, g_tp)
    return t
