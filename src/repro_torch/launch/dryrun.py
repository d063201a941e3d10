"""Multi-pod dry-run: trace every (arch x shape x mesh) cell of the
registry (``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's cost and memory analyses.  The port has no XLA: it
traces each cell's step once on the ``meta`` device (shapes without
data, the counterpart of ``ShapeDtypeStruct``; nothing is allocated and
no card is needed) under ``launch.analysis``'s counter.  It is the one
entry point of the port that runs without a card, and it never runs the
CPU's data path.  Per cell it

  1. builds the ``StepBundle`` for the production mesh's axes
     (``launch.mesh.make_production_mesh``: logical, sizes only);
  2. turns its specs into placements (``to_placements``) and the
     arguments into the per-device ones: every dimension whose spec
     names a data axis divided by its axes' sizes (an LM is rebuilt at
     its per-device batch, so its MoE routes one group a device);
  3. traces one step on ``meta`` (``trace``) and records, per device:
     FLOPs and bytes of the trace divided by the devices that split its
     work evenly (the model axis, where the parameters or an argument
     are split over it alone), ``mem_args`` exact from the specs
     (parameters, optimizer state, arguments), ``mem_temp`` the traced
     peak of the step's own allocations at the per-device batch, each
     at the caching allocator's largest block for it, with the
     workspaces of the ops that hold one (``analysis``; an upper bound
     of the card's ``max_memory_allocated`` in every registry cell that
     ``chip_smoke.py`` runs, and tensor parallelism's split of
     activations is not modelled), the collectives from the specs
     (``analysis.collective_bytes_from_specs``) and the roofline terms;
  4. for an LM at full size, traces 1- and 2-layer copies instead of
     the full depth and extrapolates exactly (``_lm_calibration``: an
     eager step is linear in the layer count); ``--no-calibration``
     traces the full depth;
  5. appends a JSON record to the output log.

``run_cell(..., device="cuda")`` runs the cell's step once on the card
under the same counter instead (the per-device batch must fit one
card) and adds the measured step time and peak.  The records keep the
reference's keys but ``compile_s``, which is ``trace_s`` here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --mesh both [--out artifacts/dryrun/dryrun_torch.jsonl]
  ... --arch grok-1-314b --shape train_4k --mesh single   (one cell)
  ... --include-skips    (also trace rule-skipped cells, e.g. long_500k)
  ... --smoke            (the smoke configs and shapes)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs import common as cc
from repro_torch.configs import get as get_arch, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.kernels import ops
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib

DEFAULT_OUT = "artifacts/dryrun/dryrun_torch.jsonl"


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec on a mesh: the counterpart of ``NamedSharding``."""
    mesh: Any
    spec: P

    def parts(self) -> int:
        return analysis.split_factor(self.spec, self.mesh.shape)


def to_placements(mesh, spec_tree):
    """A spec tree (None leaves stay None) -> a tree of ``Placement``."""
    return SH.map_specs(
        lambda s: None if s is None else Placement(mesh, s), spec_tree)


def _struct_leaves(tree) -> List[cc.Struct]:
    if isinstance(tree, cc.Struct):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _struct_leaves(v)]
    return [s for v in tree for s in _struct_leaves(v)]


def _zip_args(structs, specs):
    """(struct, spec) pairs of the arguments' leaves (a spec leaf may
    cover a subtree: each of its structs takes it)."""
    if SH.is_spec(specs) or isinstance(specs, Placement):
        return [(s, specs) for s in _struct_leaves(structs)]
    if isinstance(structs, dict):
        return [p for k in structs for p in _zip_args(structs[k], specs[k])]
    return [p for s, sp in zip(structs, specs) for p in _zip_args(s, sp)]


def local_shape(shape, spec, mesh_shape, data_axes) -> Tuple[int, ...]:
    """``shape`` per device: each dimension whose spec entry names a data
    axis divided by the sizes of all the axes it names."""
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    out = []
    for n, entry in zip(shape, spec):
        axes = SH.entry_axes(entry)
        if any(a in data_axes for a in axes):
            parts = 1
            for a in axes:
                parts *= mesh_shape[a]
            n //= parts
        out.append(int(n))
    return tuple(out)


def _slice_local(arg, spec, mesh_shape, data_axes):
    """The per-device block of an argument tree (the first block: every
    block has its shape)."""
    if isinstance(arg, torch.Tensor):
        ls = local_shape(arg.shape, spec, mesh_shape, data_axes)
        return arg[tuple(slice(0, n) for n in ls)]
    if isinstance(arg, dict):
        return {k: _slice_local(v, spec if SH.is_spec(spec) else spec[k],
                                mesh_shape, data_axes)
                for k, v in arg.items()}
    return type(arg)(_slice_local(v, spec if SH.is_spec(spec) else sp,
                                  mesh_shape, data_axes)
                     for v, sp in zip(arg, spec if not SH.is_spec(spec)
                                      else [spec] * len(arg)))


def _nbytes(st) -> int:
    n = 1
    for s in st.shape:
        n *= int(s)
    return n * torch.empty((), dtype=st.dtype).element_size()


def _arg_specs(bundle: cc.StepBundle) -> tuple:
    """The specs of the step's arguments after the model (and the
    optimizer)."""
    return tuple(bundle.in_specs[2:] if bundle.kind == "train"
                 else bundle.in_specs[1:])


def arg_bytes(bundle: cc.StepBundle, mesh) -> int:
    """Per-device bytes of the step's arguments after the model (and the
    optimizer) on ``mesh``, exact from their placements."""
    placed = to_placements(mesh, _arg_specs(bundle))
    return sum(_nbytes(st) // (pl.parts() if pl is not None else 1)
               for st, pl in _zip_args(tuple(bundle.arg_structs), placed))


def state_bytes(model, opt, pspecs, mesh_shape) -> Tuple[int, int, list]:
    """Per-device bytes of the parameters and of the optimizer state
    (each moment split like its parameter, Adafactor's row / column
    statistics like the parameter without its last / second-to-last
    dim), and every parameter's (global bytes, spec)."""
    specs = SH.module_specs(model, pspecs)
    p_bytes, o_bytes, params = 0, 0, []
    for name, p in model.named_parameters():
        spec = specs[name]
        nb = p.numel() * p.element_size()
        p_bytes += nb // analysis.split_factor(spec, mesh_shape)
        params.append((nb, spec))
        if opt is None:
            continue
        for key, t in opt.state[p].items():
            if key == "step":
                continue
            parts = tuple(spec)
            if key == "vr":
                parts = parts[:-1]
            elif key == "vc":
                parts = parts[:-2] + parts[-1:]
            o_bytes += (t.numel() * t.element_size()
                        // analysis.split_factor(P(*parts), mesh_shape))
    return p_bytes, o_bytes, params


def trace(bundle: cc.StepBundle, mesh=None, device="meta", *, seed: int = 0,
          measure: bool = False):
    """One step of ``bundle`` on ``device`` under the counter: (model,
    optimizer or None, the step's output, its ``analysis.Trace``).  With
    a ``mesh`` the arguments are the per-device blocks of
    ``bundle.make_args``.

    With ``measure`` on the card, the trace's ``measured`` gets the
    step's temporaries (``max_memory_allocated`` over it, from a reset,
    less what was alive before: ``temp_bytes``), the ``kernels.ops``
    launches it made (``launches``), whether every output tensor it made
    is finite (``finite``; an argument it hands back, as a decode step
    does its cache, is not read) and
    the CUDA-event ms of a second step run without the counter
    (``step_ms``).  The first step's output is dropped before the second
    step runs, and ``None`` is returned in its place."""
    model = bundle.init_model(seed, device)
    opt = bundle.make_optimizer(model) if bundle.kind == "train" else None
    args = bundle.make_args(seed + 1, device)
    if mesh is not None:
        data_axes = SH.from_mesh(mesh).data
        args = tuple(_slice_local(a, s, mesh.shape, data_axes)
                     for a, s in zip(args, _arg_specs(bundle)))
    lead = (model, opt) if opt is not None else (model,)
    measure = measure and torch.device(device).type == "cuda"
    if measure:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        alive = torch.cuda.memory_allocated()
        before = ops.launch_counts()
    out, tr = analysis.trace_step(bundle.step_fn, *lead, *args)
    if measure:
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - alive
        after = ops.launch_counts()
        given = {t.data_ptr() for t in analysis.tensor_leaves(args)}
        finite = all(bool(torch.isfinite(t).all())
                     for t in analysis.tensor_leaves(out)
                     if t.data_ptr() not in given)
        out = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        bundle.step_fn(*lead, *args)
        ev[1].record()
        torch.cuda.synchronize()
        tr.measured = {
            "temp_bytes": temp, "step_ms": ev[0].elapsed_time(ev[1]),
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]},
            "finite": finite}
    return model, opt, out, tr


def _token_batch(bundle: cc.StepBundle, mesh, axes: SH.Axes
                 ) -> Tuple[int, int]:
    """An LM bundle's (per-device batch, tokens a sequence): its token
    argument (``tokens`` of a train batch, a prefill's tokens, a decode
    step's one token a row) split as its spec splits it."""
    pairs = _zip_args(tuple(bundle.arg_structs), _arg_specs(bundle))
    st, spec = next((st, sp) for st, sp in pairs
                    if st.dtype == torch.int32)
    shape = local_shape(st.shape, spec, mesh.shape, axes.data)
    return shape[0], (shape[1] if len(shape) > 1 else 1)


def _lm_local(arch, cfg, shape, axes, batch: int, smoke: bool
              ) -> cc.StepBundle:
    """An LM cell's bundle at its per-device ``batch``, built for one
    data shard (its MoE routes one group)."""
    return arch.build_bundle(cfg, shape, axes, n_dp=1, smoke=smoke,
                             shape_overrides=dict(global_batch=batch))


def _lm_calibration(arch, cfg, shape, axes, batch: int, smoke: bool):
    """Per-layer (FLOPs, bytes, collective bytes) and per-layer peak and
    per-rate FLOPs, from 1- and 2-layer traces of the same cell."""
    vals = {}
    for n in (1, 2):
        c = dataclasses.replace(cfg, n_layers=n)
        b = _lm_local(arch, c, shape, axes, batch, smoke)
        vals[n] = trace(b)[3]
    t1, t2 = vals[1], vals[2]
    rates = {r: t2.flops_by_rate.get(r, 0) - t1.flops_by_rate.get(r, 0)
             for r in set(t1.flops_by_rate) | set(t2.flops_by_rate)}
    return t1, (t2.flops - t1.flops, t2.nbytes - t1.nbytes, 0.0), \
        t2.peak_live - t1.peak_live, rates


def _share(bundle: cc.StepBundle, axes: SH.Axes, mesh_shape) -> int:
    """The devices that split a per-device trace's work evenly: the model
    axis, where a parameter or an argument is split over it without a
    data axis."""
    data = set(axes.data)
    for spec in SH.spec_leaves(bundle.in_specs):
        for entry in (spec or ()):
            names = SH.entry_axes(entry)
            if axes.model in names and not data.intersection(names):
                return mesh_shape[axes.model]
    return 1


def run_cell(arch_id: str, shape: str, mesh_name: str, *,
             smoke: bool = False, calibrate: bool = True,
             device: str = "meta") -> Dict[str, Any]:
    arch = get_arch(arch_id)
    multi = mesh_name == "multi"
    mesh = mesh_lib.make_production_mesh(multi_pod=multi)
    axes = SH.from_mesh(mesh)
    n_dp = 1
    for a in axes.data:
        n_dp *= mesh.shape[a]
    chips = mesh.size

    cfg = arch.make_smoke_config() if smoke else arch.make_config()
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape, "mesh": mesh_name,
        "chips": chips, "ts": time.time(),
    }
    t0 = time.time()
    try:
        bundle = arch.build_bundle(cfg, shape, axes, n_dp=n_dp, smoke=smoke)
        trip = int(bundle.meta.get("scan_trip_count", 1))
        is_lm = arch.family == "lm"
        calib, rates, temp_layer = None, None, 0.0
        tokens_local = batch_local = 0
        if is_lm:
            batch_local, seq = _token_batch(bundle, mesh, axes)
            tokens_local = batch_local * seq
            local = _lm_local(arch, cfg, shape, axes, batch_local, smoke)
            if calibrate and trip > 1 and not smoke and device == "meta":
                tr, calib, temp_layer, rates = _lm_calibration(
                    arch, cfg, shape, axes, batch_local, smoke)
                model = local.init_model(0, "meta")
                opt = local.make_optimizer(model) \
                    if local.kind == "train" else None
            else:
                model, opt, _, tr = trace(local, device=device,
                                          measure=True)
        else:
            model, opt, _, tr = trace(bundle, mesh, device=device,
                                      measure=True)
        share = _share(bundle, axes, mesh.shape)
        p_bytes, o_bytes, params = state_bytes(
            model, opt, bundle.in_specs[0], mesh.shape)
        mem_args = p_bytes + o_bytes + arg_bytes(bundle, mesh)
        # the brute-force retrieval_cand scan gathers its (1, N) score
        # row over the corpus shards
        sp_note = {}
        if str(bundle.meta.get("note", "")).startswith("variant=brute"):
            sp_note = dict(score_row=bundle.arg_structs[-1].shape[0])
        coll = analysis.collective_bytes_from_specs(
            kind=bundle.kind, params=params, data_axes=axes.data,
            model_axis=axes.model, mesh_shape=mesh.shape,
            remat=bool(getattr(cfg, "remat", False)) and not smoke,
            lm=cfg if is_lm else None, tokens_local=tokens_local,
            batch_local=batch_local,
            decode=shape.startswith(("decode", "long")),
            cache_split=shape.startswith(("decode", "long")), **sp_note)
        cost = analysis.analyze_trace(
            tr, trip_count=trip, share=share, calibration=calib,
            rates_per_layer=rates, temp_per_layer=temp_layer,
            coll=coll.as_tuple(), mem_args=mem_args)
        roof = analysis.roofline_terms(
            cost, chips=chips,
            model_flops=float(bundle.meta.get("model_flops", 0.0)))
        rec.update(
            status="ok",
            trace_s=round(time.time() - t0, 1),
            kind=bundle.kind,
            meta={k: v for k, v in bundle.meta.items()
                  if isinstance(v, (int, float, str))},
            cost=dataclasses.asdict(cost),
            roofline=roof.as_dict(),
            calibrated=calib is not None,
            share=share,
            kernels=analysis.kernel_launches(tr),
            **({"measured": tr.measured} if tr.measured else {}),
        )
    except Exception as e:  # record failures: they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   trace_s=round(time.time() - t0, 1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--include-skips", action="store_true")
    ap.add_argument("--no-calibration", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    failures = 0
    with open(args.out, "a") as f:
        for arch_id in archs:
            arch = get_arch(arch_id)
            shapes = (arch.shapes if args.shape == "all"
                      else [args.shape])
            for shape in shapes:
                if shape in arch.skip_shapes and not args.include_skips:
                    rec = {"arch": arch_id, "shape": shape,
                           "mesh": "-", "status": "skipped",
                           "reason": arch.skip_shapes[shape]}
                    print(f"[skip] {arch_id:24s} {shape:16s} "
                          f"{arch.skip_shapes[shape][:60]}")
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    continue
                for mesh_name in meshes:
                    rec = run_cell(arch_id, shape, mesh_name,
                                   smoke=args.smoke,
                                   calibrate=not args.no_calibration)
                    ok = rec["status"] == "ok"
                    failures += 0 if ok else 1
                    if ok:
                        r = rec["roofline"]
                        print(f"[ ok ] {arch_id:24s} {shape:16s} "
                              f"{mesh_name:6s} trace={rec['trace_s']:6.1f}s "
                              f"dom={r['dominant']:10s} "
                              f"c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
                              f"x={r['collective_s']:.3e}")
                    else:
                        print(f"[FAIL] {arch_id:24s} {shape:16s} "
                              f"{mesh_name:6s} {rec['error'][:100]}")
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(f"dry-run complete; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
