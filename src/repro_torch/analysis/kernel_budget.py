"""The ``kernels`` pass: launch plans of the CUDA kernels against the card.

Counterpart of the reference's ``repro/analysis/kernel_budget.py``,
which records every ``pallas_call`` of the ``kernels.ops`` wrappers on
representative shapes and checks each block against the TPU's VMEM
budget and tile alignment.  Here every ops entry hands its launch plan
(``kernels.tiling.plan_*``) to ``kernels.launcher.run``; under
``launcher.record_launches`` the plans are recorded and nothing is
launched.  The probes drive the ops entries on ``meta`` tensors of the
reference's 11 probe shapes (``kernel_budget.py:205-285``, same labels),
and of ``port_probes`` (the HNSW search kernel, which has no Pallas
counterpart, and flash_attention at MLA's width), so the pass needs no
card, allocates no data and builds nothing, as the reference's pass runs
under ``eval_shape``.  Each recorded launch is checked against the
H100's limits, taken from ``tiling`` as the
reference takes its budget from its ``tiling``:

  PK400  a probe raised, or no launch reached the recorder (the wrapper
         took its plain version, so the kernel is unchecked).
  PK401  a block's shared memory (static + dynamic) over 232,448 B, or
         over 49,152 B without the opt-in (cudaFuncSetAttribute): the
         launch would be refused on the card.
  PK402  a block of more than 1,024 threads or not a whole number of
         warps, or a grid extent out of range (x < 2^31, y and z <=
         65,535): the launch would be refused.

``chip_smoke.py`` ``[plans]`` runs the same probes on CUDA tensors under
``torch.profiler`` and holds each recorded plan to the kernels the
trace shows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import launcher
from repro_torch.kernels import tiling as _tiling
from repro_torch.kernels.tiling import Launch

PASS_ID = "kernel-budget"

SMEM_OPT_IN_BYTES = _tiling.SMEM_BLOCK_BYTES
SMEM_DEFAULT_BYTES = _tiling.SMEM_DEFAULT_BYTES
MAX_BLOCK_THREADS = _tiling.MAX_BLOCK_THREADS
WARP = _tiling.WARP
MAX_GRID = (_tiling.MAX_GRID_X, _tiling.MAX_GRID_Y, _tiling.MAX_GRID_Z)


@dataclasses.dataclass(frozen=True)
class Arg:
    """One operand of a probe: its shape and dtype; integer operands
    draw values in [low, high) when the probe runs on real tensors."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    low: int = 0
    high: int = 1


@dataclasses.dataclass(frozen=True)
class Probe:
    """One ops entry on fixed shapes: ``call(*tensors, device=...)``."""

    label: str
    args: Tuple[Arg, ...]
    call: Callable[..., object]

    def tensors(self, device, generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """The operands: empty on ``meta``, else drawn from
        ``generator`` (floats normal, integers in [low, high))."""
        out = []
        for a in self.args:
            if torch.device(device).type == "meta":
                out.append(torch.empty(a.shape, dtype=a.dtype,
                                       device=device))
            elif a.dtype.is_floating_point:
                out.append(torch.randn(a.shape, generator=generator,
                                       device=device).to(a.dtype))
            else:
                out.append(torch.randint(a.low, a.high, a.shape,
                                         generator=generator, device=device,
                                         dtype=torch.int64).to(a.dtype))
        return out


def _f32(*shape) -> Arg:
    return Arg(shape)


def _ids(*shape, n: int) -> Arg:
    """Doc ids in [-1, n): -1 marks a pad slot."""
    return Arg(shape, torch.int32, -1, n)


def _idx(*shape, n: int) -> Arg:
    """Indices in [0, n) (list selections, bag ids)."""
    return Arg(shape, torch.int32, 0, n)


def default_probes() -> List[Probe]:
    """The reference's 11 probes (``repro/analysis/kernel_budget.py``
    ``default_probes``), same labels and shapes, on the port's ops."""
    from repro_torch.kernels import ops

    def ivf(d):
        return Probe(f"ops.ivf_scan[d={d}]",
                     (_f32(8, d), _f32(64, 2048, d),
                      _ids(64, 2048, n=100_000), _idx(8, 8, n=64)),
                     lambda q, lv, li, sel, device: ops.ivf_scan(
                         q, lv, li, sel, 32, device=device))

    def fused(precision):
        return Probe(f"ops.fused_turn[{precision}]",
                     (_f32(8, 128), _f32(4096, 128), _f32(4096, 512, 128),
                      _ids(4096, 512, n=100_000)),
                     lambda q, c, lv, li, device: ops.fused_turn(
                         q, c, lv, li, nprobe=8, k=32, precision=precision,
                         device=device))

    return [
        ivf(128),
        ivf(1024),
        Probe("ops.pq_adc_scan",
              (_f32(8, 16, 256), Arg((64, 4096, 16), torch.uint8, 0, 256),
               _ids(64, 4096, n=100_000), _idx(8, 8, n=64)),
              lambda t, c, li, sel, device: ops.pq_adc_scan(
                  t, c, li, sel, 32, device=device)),
        Probe("ops.centroid_topk", (_f32(32, 128), _f32(4096, 128)),
              lambda q, c, device: ops.centroid_topk(q, c, 64,
                                                     device=device)),
        Probe("ops.flash_attention", (_f32(1, 4, 1024, 128),) * 3,
              lambda q, k, v, device: ops.flash_attention(
                  q, k, v, causal=True, device=device)),
        Probe("ops.flash_decode",
              (_f32(4, 8, 128), _f32(4, 2, 2048, 128),
               _f32(4, 2, 2048, 128), Arg((4,), torch.int32, 1, 2049)),
              lambda q, k, v, n, device: ops.flash_decode(q, k, v, n,
                                                          device=device)),
        Probe("ops.embedding_bag", (_f32(50000, 256), _idx(8, 16, n=50000)),
              lambda t, ids, device: ops.embedding_bag(t, ids,
                                                       device=device)),
        fused("f32"),
        fused("int8"),
        Probe("ops.fused_turn_pq",
              (_f32(8, 128), _f32(4096, 128), _f32(8, 16, 256),
               Arg((4096, 512, 16), torch.uint8, 0, 256),
               _ids(4096, 512, n=50000), _f32(50000, 128)),
              lambda q, c, t, cd, li, dv, device: ops.fused_turn_pq(
                  q, c, t, cd, li, dv, nprobe=8, k=32, rerank=64,
                  device=device)),
        Probe("ops.fused_scan",
              (_f32(8, 128), _f32(4096, 512, 128),
               _ids(4096, 512, n=100_000), _idx(8, 8, n=4096)),
              lambda q, lv, li, sel, device: ops.fused_scan(
                  q, lv, li, sel, 32, device=device)),
    ]


def port_probes() -> List[Probe]:
    """Probes of the port's kernels that no Pallas kernel of the
    reference has: ``ops.hnsw_search`` (the reference's traversal is an
    XLA ``while_loop``) at d = 768, m = 16 and three upper levels, k =
    10, at each instance of its visited set (``tiling.hnsw_visited``):
    on a graph of 20,000 nodes at ef = 64 (the shared bitmap) at a
    request (B = 1) and at the batched engine's largest wave (B = 32);
    on 1,000,000 nodes at ef = 64 (the shared hash) and on 2,000,000 at
    ef = 256 (the global bitmap), B = 32; and ``ops.flash_attention``
    past the reference's probe widths, at MLA's bf16 prefill
    (DeepSeek-V2-Lite: H = Hkv = 16, S = 784, D = 192, Dv = 128, causal;
    a wide instance, its query rows in shared memory)."""
    from repro_torch.kernels import ops
    d, m = 768, 16
    bf16 = torch.bfloat16

    def hnsw(label, b, n, ef):
        return Probe(f"ops.hnsw_search[{label}]",
                     (_f32(n, d), _ids(n, 2 * m, n=n), _ids(3, n, m, n=n),
                      Arg((), torch.int32, 0, n), _f32(b, d)),
                     lambda v, a0, up, e, q, device: ops.hnsw_search(
                         v, a0, up, e, q, ef=ef, k=10, device=device))

    return [hnsw("B=1", 1, 20_000, 64), hnsw("B=32", 32, 20_000, 64),
            hnsw("hash,B=32", 32, 1_000_000, 64),
            hnsw("global,B=32", 32, 2_000_000, 256),
            Probe("ops.flash_attention[mla]",
                  (Arg((1, 16, 784, 192), bf16),) * 2
                  + (Arg((1, 16, 784, 128), bf16),),
                  lambda q, k, v, device: ops.flash_attention(
                      q, k, v, causal=True, device=device))]


def record(probe: Probe, tensors: Optional[Sequence[torch.Tensor]] = None,
           device="meta") -> List[launcher.Record]:
    """The entry calls of one probe, recorded: on meta tensors of its
    shapes, or on the given ``tensors`` on ``device``."""
    if tensors is None:
        tensors = probe.tensors(device)
    with launcher.record_launches() as records:
        probe.call(*tensors, device=device)
    return records


Kernel = Tuple[str, Tuple[int, ...], Tuple[int, ...], int]


def planned(probe: Probe, tensors: Sequence[torch.Tensor], device
            ) -> List[Kernel]:
    """(kernel, grid, block, static + dynamic shared memory) of every
    launch the probe's call plans on these tensors, recorded."""
    return [(x.kernel, x.grid, x.block, x.smem_bytes)
            for r in record(probe, tensors, device) for x in r.plan]


def lost_events(seen: Sequence, want: Sequence) -> bool:
    """Is ``seen`` ``want`` with kernels missing, the rest in order?"""
    rest = iter(want)
    return len(seen) < len(want) and all(k in rest for k in seen)


def traced(probe: Probe, tensors: Sequence[torch.Tensor], device,
           want: Sequence[Kernel], tries: int = 3,
           before: Optional[Callable[[], None]] = None) -> List[Kernel]:
    """The (kernel, grid, block, shared memory) tuples of the kernels
    ``torch.profiler`` sees when the probe's call runs on the card
    (after one warm-up call), in launch order, from the Kineto trace's
    kernel events ("grid", "block", "shared memory": static plus
    dynamic).  ``before`` runs ahead of each traced call
    (``kernels.ops.drop_scales``: the call then runs the one-time int8
    scale pass as a first call does).  Each session first runs the call
    in a warm-up step whose events are discarded (``schedule(warmup=1,
    active=1)``) and records only the second: the activity tracing a
    session starts can miss the first kernel launched behind it.

    A session whose trace is ``want`` (the recorded plan) with kernels
    missing (``lost_events``), while the ops wrappers' launch counts show
    both of its calls launching as the warm-up call did, is the profiler
    losing events: it is taken again, with the host's activity traced
    too, up to ``tries`` times (``traced.retaken`` counts them).  Any
    other trace, a short one whose launches the counts do not show
    included, is returned at once for the caller to compare."""
    from repro_torch.kernels import ops

    def launched(counts):
        now = ops.launch_counts()
        return {n: c - counts[n] for n, c in now.items() if c != counts[n]}

    counts = ops.launch_counts()
    probe.call(*tensors, device=device)
    torch.cuda.synchronize()
    session = {n: 2 * c for n, c in launched(counts).items()}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries + 1):
        counts = ops.launch_counts()
        out = _trace_session(probe, tensors, device, acts, before)
        if (attempt == tries or not lost_events(out, want) or not session
                or launched(counts) != session):
            return out
        traced.retaken += 1
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]


traced.retaken = 0


def _trace_session(probe: Probe, tensors: Sequence[torch.Tensor], device,
                   acts, before: Optional[Callable[[], None]]
                   ) -> List[Kernel]:
    """One profiler session of ``traced``: a discarded warm-up step and a
    recorded one, the probe's call in each."""
    import json
    import os
    import re
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(path)
                ) as prof:
            for _ in range(2):
                if before is not None:
                    before()
                probe.call(*tensors, device=device)
                torch.cuda.synchronize()
                prof.step()
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    out = []
    for e in sorted((e for e in events if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"]):
        name = e["name"].replace("(anonymous namespace)::", "")
        m = re.search(r"(\w+)\s*(?:<[^()]*>)?\s*\(", name)
        a = e["args"]
        out.append((m.group(1) if m else name, tuple(a["grid"]),
                    tuple(a["block"]), int(a["shared memory"])))
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _where(label: str, entry: str, launch: Launch) -> str:
    return f"{label} entry `{entry}` kernel `{launch.kernel}`"


def check_smem(launch: Launch, where: str) -> List[Finding]:
    cap = SMEM_OPT_IN_BYTES if launch.opt_in else SMEM_DEFAULT_BYTES
    if launch.smem_bytes <= cap:
        return []
    how = ("the opt-in maximum" if launch.opt_in else
           "the default without cudaFuncSetAttribute")
    return [Finding(PASS_ID, "PK401", "", 0,
                    f"{where}: {launch.smem_bytes} B of shared memory a "
                    f"block ({launch.dyn_smem_bytes} dynamic) exceeds "
                    f"{cap} B, {how}; grid={launch.grid}")]


def check_shape(launch: Launch, where: str) -> List[Finding]:
    out = []
    threads = launch.block[0] * launch.block[1] * launch.block[2]
    if not 0 < threads <= MAX_BLOCK_THREADS or threads % WARP:
        out.append(Finding(PASS_ID, "PK402", "", 0,
                           f"{where}: a block of {threads} threads "
                           f"{launch.block}: need a multiple of {WARP} "
                           f"up to {MAX_BLOCK_THREADS}"))
    for axis, (g, cap) in enumerate(zip(launch.grid, MAX_GRID)):
        if not 0 < g <= cap:
            out.append(Finding(PASS_ID, "PK402", "", 0,
                               f"{where}: grid {'xyz'[axis]} = {g} outside "
                               f"[1, {cap}]; grid={launch.grid}"))
    return out


#: per probe of the last ``run``: (label, entries called, launches)
last_report: List[Tuple[str, List[str], int]] = []


def run(probes: Optional[Sequence[Probe]] = None) -> List[Finding]:
    findings: List[Finding] = []
    last_report.clear()
    for probe in (probes if probes is not None
                  else default_probes() + port_probes()):
        try:
            records = record(probe)
        except Exception as e:  # noqa: BLE001 - surface, don't abort
            findings.append(Finding(
                PASS_ID, "PK400", "", 0,
                f"{probe.label}: kernel probe failed: "
                f"{type(e).__name__}: {e}"))
            continue
        n = sum(len(r.plan) for r in records)
        last_report.append((probe.label, [r.entry for r in records], n))
        if n == 0:
            findings.append(Finding(
                PASS_ID, "PK400", "", 0,
                f"{probe.label}: no launch reached the recorder — the "
                f"dispatch wrapper took its plain version, so the kernel "
                f"is unchecked"))
        for r in records:
            for launch in r.plan:
                where = _where(probe.label, r.entry, launch)
                findings += check_smem(launch, where)
                findings += check_shape(launch, where)
    return findings
