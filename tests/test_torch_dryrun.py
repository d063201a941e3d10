"""The port's dry-run and cost analysis (``launch/dryrun.py``,
``launch/analysis.py``, ``kernels/cost.py``) on the CPU, on ``meta``.

* The reference's ``test_roofline_terms_math`` and
  ``test_calibration_adjustment`` at the H100's constants.
* Calibrated == full depth: the 1- and 2-layer traces extrapolate to the
  4-layer trace's FLOPs and bytes exactly (its temporaries within 1e-4),
  for a dense LM and for the MLA / MoE one.
* A hand count of the products of one small dense-LM train step equals
  the trace's FLOPs.
* A ``flash_attention`` call on ``meta`` is counted once, by
  ``kernels/cost.py``'s formula, and its output's ``empty`` counts
  nothing.
* The recsys serve cells move no collective bytes; a train cell's
  collectives on a (2, 4) mesh equal a hand count.
* ``main(["--smoke", ...])`` prints the reference's line forms and exits
  0 over every cell on both meshes, and 1 with a ``[FAIL]`` line on a
  cell that fails.
* Every recsys / GIN host-id check still raises on bad CPU ids, and the
  GIN edge counts are ``bincount``'s on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import common as TC
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import cost, ops
from repro_torch.launch import analysis as AN
from repro_torch.launch import dryrun as D
from repro_torch.models import gnn, recsys as R


def test_roofline_terms_math():
    cost_ = AN.CellCost(
        flops=989e12,          # exactly 1 second of one card's bf16 peak
        hbm_bytes=3.35e12,     # exactly 1 second of HBM
        coll_bytes=25e9,       # 0.5 s at 50 GB/s
        coll_by_kind={}, mem_args=0, mem_temp=0, mem_output=0,
        peak_memory=0, raw_flops=989e12)
    roof = AN.roofline_terms(cost_, chips=256, model_flops=256 * 989e12)
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(0.5)
    assert roof.model_flops_ratio == pytest.approx(1.0)
    assert roof.dominant in ("compute", "memory")
    # by rate class and by group: f32 at 67 TFLOP/s, NVLink in a node
    split = dataclasses.replace(cost_, flops_by_rate={"f32": 67e12,
                                                      "bf16": 989e12},
                                coll_by_group={8: 450e9, 16: 50e9})
    roof = AN.roofline_terms(split, chips=1, model_flops=0.0)
    assert roof.compute_s == pytest.approx(2.0)
    assert roof.collective_s == pytest.approx(2.0)
    for c in ("197e12", "819e9"):
        assert c not in open(AN.__file__).read()


def test_calibration_adjustment():
    tr = AN.Trace(flops=100, flops_by_rate={"bf16": 100}, nbytes=1000,
                  peak_live=2)
    c = AN.analyze_trace(tr, trip_count=48, calibration=(10.0, 100.0, 5.0),
                         mem_args=1.0, temp_per_layer=0.5)
    assert c.flops == pytest.approx(100.0 + 47 * 10.0)
    assert c.hbm_bytes == pytest.approx(1000.0 + 47 * 100.0)
    assert c.mem_temp == pytest.approx(2 + 47 * 0.5)
    assert c.peak_memory == pytest.approx(1.0 + 2 + 47 * 0.5)
    assert "calibrated" in c.adjust_note
    assert c.raw_flops == 100
    plain = AN.analyze_trace(tr, trip_count=48, share=4)
    assert plain.flops == 25 and plain.hbm_bytes == 250
    assert "full depth" in plain.adjust_note


@pytest.mark.parametrize("arch_id,shape", [
    ("yi-9b", "train_4k"), ("yi-9b", "decode_32k"),
    ("deepseek-v2-lite-16b", "train_4k"),
    ("deepseek-v2-lite-16b", "prefill_32k")])
def test_calibrated_equals_full_depth(arch_id, shape):
    arch = TC.get(arch_id)
    cfg = dataclasses.replace(arch.make_smoke_config(), n_layers=4)
    axes = SH.Axes()
    # the single pod's per-device batch: 64 / 16 rows, a prefill's 32 / 16
    batch = 2 if shape == "prefill_32k" else 4
    t1, (per_f, per_b, _), per_temp, rates = D._lm_calibration(
        arch, cfg, shape, axes, batch, True)
    full = D.trace(D._lm_local(arch, cfg, shape, axes, batch, True))[3]
    assert t1.flops + 3 * per_f == full.flops
    assert t1.nbytes + 3 * per_b == full.nbytes
    # the peak is linear but for a few scalars (the MoE's stacked aux
    # losses)
    assert t1.peak_live + 3 * per_temp == pytest.approx(full.peak_live,
                                                        rel=1e-4)
    for r, f in full.flops_by_rate.items():
        assert t1.flops_by_rate.get(r, 0) + 3 * rates[r] == f


def test_hand_count_of_a_dense_lm_train_step():
    """Yi's smoke LM (2 layers, d 64, 4 heads of 16, GQA 2, SwiGLU 128,
    vocab 512, no remat), B = 2, S = 32: every projection and the head
    once forward and twice backward (dX, dW), the head's loss chunks
    recomputed (checkpointed) in the backward; row 8 forward by its
    formula (causal); its backward the plain VJP: the plain attention
    recomputed (QK^T and PV over all S x S, the mask after) and its two
    products' backward, twice each."""
    arch = TC.get("yi-9b")
    cfg = arch.make_smoke_config()
    b, s = 2, 32
    bundle = arch.build_bundle(cfg, "train_4k", smoke=True,
                               shape_overrides=dict(global_batch=b,
                                                    seq_len=s))
    _, _, _, tr = D.trace(bundle)
    t, d, h, hkv, dh = b * s, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_head
    proj = 2 * t * d * (2 * h * dh + 2 * hkv * dh) + 3 * 2 * t * d * cfg.d_ff
    head = 2 * t * d * cfg.vocab
    attn_kernel = cost.attn_cost((b, h, s, dh), (b, hkv, s, dh),
                                 (b, hkv, s, dh), torch.float32, True).flops
    plain = 2 * (2 * b * h * s * s * dh)        # QK^T and PV, unmasked
    want = cfg.n_layers * (3 * proj + attn_kernel + 3 * plain) + 4 * head
    assert tr.flops == want, (tr.flops, want, tr.flops_by_op)
    assert tr.kernels == {"flash_attention_f32": cfg.n_layers}


def test_a_meta_flash_attention_call_is_counted_once():
    q = torch.empty((2, 4, 64, 16), device="meta")
    k = torch.empty((2, 2, 64, 16), device="meta")
    with torch.no_grad():
        _, tr = AN.trace_step(lambda *x: ops.flash_attention(
            *x, causal=True, device="meta"), q, k, k)
    c = cost.attn_cost(q.shape, k.shape, k.shape, q.dtype, True)
    assert tr.kernels == {"flash_attention_f32": 1}
    assert AN.kernel_launches(tr) == {"flash_attention": 1}
    assert tr.flops == c.flops and tr.flops_by_rate == {"tf32x3": c.flops}
    assert tr.nbytes == c.nbytes
    assert "empty" not in tr.bytes_by_op
    assert ops.flash_attention.launches == ops.flash_attention.launches


def test_block_bytes_bound_the_caching_allocator():
    """512-byte rounding; above 1 MiB up to 1 MiB of an unsplit block."""
    mib = 1 << 20
    assert AN.block_bytes(0) == 0
    assert AN.block_bytes(1) == AN.block_bytes(512) == 512
    assert AN.block_bytes(513) == 1024
    assert AN.block_bytes(mib) == mib
    assert AN.block_bytes(mib + 1) == mib + 512 + mib


def test_live_bytes_follow_storages_and_workspaces():
    """A storage counts from the op that makes it until it dies (a view
    keeps it), at its block size; ``_softmax_backward_data`` holds a
    copy of the gradient while it runs."""
    g = torch.empty((64, 128), device="meta")
    y = torch.empty((64, 128), device="meta")
    nb = AN.block_bytes(64 * 128 * 4)

    sbd = torch.ops.aten._softmax_backward_data
    _, tr = AN.trace_step(lambda g, y: sbd(g, y, -1, torch.float32), g, y)
    assert tr.peak_live == 2 * nb          # its output and the copy of g

    def step(g):
        a = g * 2
        v = (a * 3)[:1]          # a and a * 3: 2 blocks
        del a                    # a * 3 lives on in its view v
        w = g * 5                # a * 3 and w: 2 blocks
        return v + w[:1]         # and 512 bytes

    out, tr = AN.trace_step(step, g)
    assert tr.peak_live == 2 * nb + 512 and out.shape == (1, 128)
    _, tr = AN.trace_step(lambda g: (g * 2, g * 3, g * 4), g)
    assert tr.peak_live == 3 * nb


@pytest.mark.parametrize("arch_id", ["dcn-v2", "bst", "autoint",
                                     "two-tower-retrieval"])
def test_recsys_serve_cells_move_no_collective_bytes(arch_id):
    for shape in ("serve_p99", "serve_bulk"):
        for mesh in ("single", "multi"):
            rec = D.run_cell(arch_id, shape, mesh, smoke=True)
            assert rec["status"] == "ok", rec.get("error")
            assert rec["cost"]["coll_bytes"] == 0.0
            assert rec["roofline"]["collective_s"] == 0.0
            assert rec["share"] == 1


def test_train_cell_collectives_by_hand():
    """dcn-v2's smoke train cell on a (2, 4) mesh: no parameter is split
    over the data axis, so each is all-reduced over the 2 data shards:
    2 (g - 1) / g = 1 x its bytes a device (its split over the model
    axis)."""
    arch = TC.get("dcn-v2")
    cfg = arch.make_smoke_config()
    shape_ = {"data": 2, "model": 4}
    bundle = arch.build_bundle(cfg, "train_batch", smoke=True)
    model = bundle.init_model(0, "meta")
    _, _, params = D.state_bytes(model, None, bundle.in_specs[0], shape_)
    tally = AN.collective_bytes_from_specs(
        kind="train", params=params, data_axes=("data",),
        model_axis="model", mesh_shape=shape_)
    want = 0.0
    for name, p in model.named_parameters():
        nb = p.numel() * 4
        split = 4 if name in ("table",) or name.startswith("deep.weights") \
            or name == "deep.biases.0" else 1
        want += nb / split
    assert tally.total == pytest.approx(want)
    assert set(tally.by_kind) == {"all-reduce"}
    assert tally.by_group == {2: pytest.approx(want)}
    # FSDP: a leaf split over the data axis is gathered (forward,
    # backward, recompute) and its gradient reduce-scattered
    fsdp = AN.collective_bytes_from_specs(
        kind="train", params=[(800.0, SH.P("data", "model"))],
        data_axes=("data",), model_axis="model", mesh_shape=shape_,
        remat=True)
    local = 800.0 / 8
    assert fsdp.by_kind["all-gather"] == pytest.approx(
        3 * local * 2 * (2 - 1) / 2)
    assert fsdp.by_kind["reduce-scatter"] == pytest.approx(local * (2 - 1))


def test_main_prints_the_reference_lines(tmp_path, capsys):
    out = str(tmp_path / "dry.jsonl")
    assert D.main(["--smoke", "--arch", "all", "--mesh", "both",
                   "--out", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "dry-run complete; 0 failures"
    assert all(ln.startswith(("[ ok ] ", "[skip] ")) for ln in lines[:-1])
    assert sum(ln.startswith("[ ok ] ") for ln in lines) == 70
    assert sum(ln.startswith("[skip] ") for ln in lines) == 5
    import json
    with open(out) as f:
        recs = [json.loads(x) for x in f]
    ok = [r for r in recs if r["status"] == "ok"]
    assert {"arch", "shape", "mesh", "chips", "ts", "trace_s", "kind",
            "meta", "cost", "roofline", "calibrated"} <= set(ok[0])
    assert D.main(["--smoke", "--arch", "dcn-v2", "--shape", "nope",
                   "--mesh", "single", "--out", out]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[FAIL] dcn-v2")
    assert lines[-1] == "dry-run complete; 1 failures"


def test_host_id_checks_still_fire():
    for name, cls in (("dcn-v2", R.DCNv2), ("autoint", R.AutoInt)):
        cfg = TC.get(name).make_smoke_config()
        m = TC.get(name).build_bundle(cfg, "serve_p99", smoke=True
                                      ).init_model(0, "cpu")
        bad = np.full((2, cfg.n_sparse), 64, np.int32)
        with pytest.raises(ValueError, match="field"):
            m(np.zeros((2, cfg.n_dense), np.float32), bad) \
                if name == "dcn-v2" else m(bad)
    cfg = TC.get("bst").make_smoke_config()
    m = TC.get("bst").build_bundle(cfg, "serve_p99", smoke=True
                                   ).init_model(0, "cpu")
    with pytest.raises(ValueError):
        m(np.full((2, cfg.seq_len), cfg.item_vocab, np.int32),
          np.zeros(2, np.int32), np.zeros((2, cfg.n_other), np.int32))
    cfg = TC.get("two-tower-retrieval").make_smoke_config()
    tt = R.two_tower_init(cfg, 0, "cpu")
    with pytest.raises(ValueError):
        tt.user_tower(np.array([cfg.user_vocab], np.int32),
                      np.zeros((1, cfg.history_len), np.int32))
    gcfg = dataclasses.replace(TC.get("gin-tu").make_smoke_config(),
                               d_in=4, n_classes=3)
    g = gnn.GIN(gcfg, gnn.init_params(gcfg, TC.seeded("cpu", 0)))
    with pytest.raises(ValueError, match="node ids"):
        g.forward_node(np.zeros((5, 4), np.float32), np.array([0, 5]),
                       np.array([1, 2]))
    dst = torch.tensor([3, 0, 3, 1])
    order = gnn.edge_order(torch.tensor([0, 1, 2, 3]), dst, 5)
    assert torch.equal(order.lengths, torch.bincount(dst, minlength=5))
    meta = gnn.edge_order(dst.to("meta"), dst.to("meta"), 5)
    assert meta.lengths.shape == (5,) and meta.lengths.device.type == "meta"
