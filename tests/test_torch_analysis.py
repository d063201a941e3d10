"""The port's ``kernels`` analysis pass (``repro_torch.analysis``).

It records the launch plan of every ``kernels.ops`` entry on ``meta``
tensors of the reference's 11 probe shapes, and of the port's probes of
the HNSW search kernel (``port_probes``), and checks each launch
against the H100's limits.  Here, on the CPU: the tree is clean, the
probes match the reference's by label, every probe records a launch with
no build and no data, fixtures defined here fire each code, and the CLI
keeps the reference's exit codes.  That the plans equal the kernels a
profiler traces is checked on the card (``chip_smoke.py`` ``[plans]``,
``tests/test_torch_kernels.py``).
"""
import json

import pytest
import torch

from repro.analysis import kernel_budget as ref_budget
from repro_torch import analysis
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import kernel_budget as kb
from repro_torch.kernels import _build, launcher, ops, tiling
from repro_torch.kernels.tiling import Launch


@pytest.fixture
def no_build(monkeypatch):
    """Fail any attempt to build or load the kernel library."""
    def refuse(*a, **k):
        raise AssertionError("the analysis pass built or loaded kernels")
    monkeypatch.setattr(_build, "lib", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_the_tree_has_no_findings(no_build):
    assert kb.run() == []
    assert len(kb.last_report) == 11 + len(kb.port_probes())


def test_probes_are_the_references(no_build):
    labels = [label for label, _ in ref_budget.default_probes()]
    assert [p.label for p in kb.default_probes()] == labels


@pytest.mark.parametrize("label", [p.label for p in kb.default_probes()
                                   + kb.port_probes()])
def test_every_probe_records_a_launch_and_counts_none(no_build, label):
    probe = next(p for p in kb.default_probes() + kb.port_probes()
                 if p.label == label)
    before = {n: getattr(ops, n).launches for n in (
        "centroid_topk", "ivf_scan", "fused_turn", "fused_scan",
        "pq_adc_scan", "fused_turn_pq", "flash_attention", "flash_decode",
        "embedding_bag", "hnsw_search")}
    records = kb.record(probe)
    assert records and all(r.plan for r in records)
    for r in records:
        for x in r.plan:
            assert x.kernel in tiling.STATIC_SMEM
            assert kb.check_smem(x, label) == kb.check_shape(x, label) == []
    assert {n: getattr(ops, n).launches for n in before} == before


def test_recorded_plans_are_the_tiling_plans(no_build):
    """The int8 fused turn's first call on an index records the one-time
    scale passes of its lists and its centroids, then its entry: stage 1
    and its merge (a tile of 8 queries: past the stage-1 fold) and the
    scan, which folds its lists and re-ranks them in its own launch, in
    launch order.  The bag probe at B = 1 and 512 records its entry's
    plan."""
    probe = next(p for p in kb.default_probes()
                 if p.label == "ops.fused_turn[int8]")
    records = kb.record(probe)
    assert [r.entry for r in records] == ["group_amax", "group_amax",
                                          "fused_turn_ivf"]
    assert records[0].plan == tiling.plan_group_amax(4096, 512)
    assert records[1].plan == tiling.plan_group_amax(1, 4096)
    rec = records[2]
    assert [x.kernel for x in rec.plan] == [
        "centroid_chunk_kernel", "merge_kernel", "scan_lists_kernel"]
    assert rec.plan == tiling.plan_fused_turn_ivf(8, 4096, 8, 8, 512, 128,
                                                  "int8", 64)
    # embedding_bag at a request (B = 1) and at serve_p99 (B = 512): the
    # entry's plan, the small-batch kernel up to BAG_ROWS_MAX_B
    bag = next(p for p in kb.default_probes() if p.label == "ops.embedding_bag")
    table = torch.empty((50_000, 256), device="meta")
    for b in (1, 512):
        ids = torch.empty((b, 50), dtype=torch.int32, device="meta")
        (rec,) = kb.record(bag, (table, ids))
        assert rec.entry == "embedding_bag_f32"
        assert rec.plan == tiling.plan_embedding_bag(b, 256)
        assert rec.plan[0].kernel == ("bag_rows_kernel"
                                      if b <= tiling.BAG_ROWS_MAX_B
                                      else "embedding_bag_kernel")


@pytest.mark.parametrize("n_lists,w", [(1, 16), (384, 16), (320, 128),
                                       (256, 2048), (128, 1024)])
def test_merge_plans_launch_one_kernel_a_pass(n_lists, w):
    plan = tiling.plan_merge(3, n_lists, w)
    passes = tiling.merge_plan(n_lists, w)
    assert [x.grid for x in plan] == [(3, g, 1) for _, g in passes]
    assert len({x.dyn_smem_bytes for x in plan}) == 1
    assert plan[0].smem_bytes <= tiling.SMEM_BLOCK_BYTES


@pytest.mark.parametrize("b,d,grid_y,dyn,static", [
    (1, 768, 1, 16 * 64 * 12, 8 * 129 * 4),  # one query: a fold level
    (8, 768, 1, 8 * 768 * 4, 8 * 129 * 4),
    (25, 768, 1, 25 * 768 * 4, 32 * 129 * 4),  # 32 queries: the table once
    (40, 768, 2, 32 * 768 * 4, 32 * 129 * 4),
    (25, 2048, 4, 8 * 2048 * 4, 8 * 129 * 4)])  # 32 rows of 2,048 too wide
def test_stage1_plans_tile_the_queries(b, d, grid_y, dyn, static):
    """Stage 1 reads the centroid table once per tile of 8 queries (B <=
    8) or 32, each staged in dynamic shared memory; its chunk lists are
    min(kp, 128) wide.  A tile of one query folds them in its own launch
    in two levels (its shared memory then holds a group's 16 lists of 64);
    wider tiles merge them in one kernel at kp = 64."""
    fold = b == 1
    assert tiling.select_fold(b, 16_384, d, 64) == fold
    plan = tiling.plan_select(b, 16_384, d, 64, "f32")
    chunk = plan[0]
    assert chunk.kernel == "centroid_chunk_kernel"
    assert chunk.grid == (128, grid_y, 1)
    assert (chunk.dyn_smem_bytes, chunk.static_smem_bytes) == (dyn, static)
    assert [x.kernel for x in plan[1:]] == ([] if fold else ["merge_kernel"])
    if not fold:
        assert plan[1].grid == (b, 1, 1)
        assert plan[1].dyn_smem_bytes == 128 * 64 * tiling.MERGE_ENTRY_BYTES
    # the top-h cache, never folded: groups of 16 lists of 128 grow into
    # 1,024 on 8 blocks a query, then one block merges the 8
    assert not tiling.select_fold(b, 16_384, d, 1024)
    (_, grow, last) = tiling.plan_select(b, 16_384, d, 1024, "f32")
    assert (grow.grid, last.grid) == ((b, 8, 1), (b, 1, 1))
    assert grow.dyn_smem_bytes == last.dyn_smem_bytes == max(
        16 * 128 + 1024, 8 * 1024) * tiling.MERGE_ENTRY_BYTES


@pytest.mark.parametrize("precision,kernels", [
    ("f32", ["scan_lists_kernel"]),
    ("bf16", ["scan_lists_kernel"]),
    ("int8", ["scan_lists_kernel"])])
def test_scan_plans_fold_in_the_launch_at_the_served_shape(precision,
                                                           kernels):
    """fused_scan at the smoke's shape (nprobe 64, Lmax 702, d 768, k 10;
    the quantised r = 20): the scan folds its lists in its own launch and
    re-ranks the quantised candidates there too, and int8 reads the
    index's cached scales, so every precision is one kernel; its shared
    memory holds the query or the fold's 64 lists of r_pad, the
    larger."""
    r_pad = 16 if precision == "f32" else 32
    plan = tiling.plan_fused_scan_ivf(1, 64, 702, 768, precision, r_pad)
    assert [x.kernel for x in plan] == kernels
    scan = plan[kernels.index("scan_lists_kernel")]
    assert scan.grid == (64 * 6, 1, 1)
    assert scan.dyn_smem_bytes == 64 * r_pad * tiling.MERGE_ENTRY_BYTES
    assert tiling.scan_fold(64, 702, r_pad)


@pytest.mark.parametrize("nprobe,lmax,r_pad,fold", [
    (64, 702, 16, True), (32, 1220, 128, True), (64, 702, 256, False),
    (256, 40, 128, False), (64, 702, 2048, False)])
def test_scan_plans_merge_after_the_launch_past_the_fold(nprobe, lmax,
                                                         r_pad, fold):
    """Past one slice's 128 rows, or past the fold's shared memory, the
    scan's lists of min(r_pad, 128) merge after it (growing to r_pad)."""
    plan = tiling.plan_fused_scan_ivf(2, nprobe, lmax, 64, "f32", r_pad)
    assert tiling.scan_fold(nprobe, lmax, r_pad) == fold
    merges = [x for x in plan if x.kernel == "merge_kernel"]
    n_lists = nprobe * tiling.scan_split(lmax)
    w_in = min(r_pad, tiling.SCAN_ROWS)
    assert len(merges) == (0 if fold else
                           len(tiling.merge_plan(n_lists, r_pad, w_in)))
    for x in plan:
        assert x.smem_bytes <= tiling.SMEM_BLOCK_BYTES


def test_meta_tensors_are_refused_outside_the_recorder():
    m = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor required"):
        ops.centroid_topk(m, torch.empty((16, 8), device="meta"), 2,
                          device="meta")
    assert not launcher.recording()


def _entry(plan):
    """A probe whose call hands ``plan`` straight to the launcher."""
    return kb.Probe("fixture", (), lambda device: launcher.run(
        "fixture_entry", plan, torch.device("meta")))


def _codes(findings):
    return sorted(f.code for f in findings)


def test_pk400_a_probe_that_raises():
    def boom(device):
        raise RuntimeError("no such shape")
    (f,) = kb.run([kb.Probe("raises", (), boom)])
    assert f.code == "PK400" and "no such shape" in f.message


def test_pk400_a_probe_that_takes_the_plain_version():
    """CPU tensors take the plain version: nothing reaches the recorder."""
    probe = kb.Probe("plain", (), lambda device: ops.centroid_topk(
        torch.zeros((2, 8)), torch.zeros((16, 8)), 2, device="cpu"))
    (f,) = kb.run([probe])
    assert f.code == "PK400" and "plain version" in f.message


@pytest.mark.parametrize("smem,opt_in,fires", [
    (tiling.SMEM_BLOCK_BYTES, True, False),
    (tiling.SMEM_BLOCK_BYTES + 1, True, True),
    (tiling.SMEM_DEFAULT_BYTES, False, False),
    (tiling.SMEM_DEFAULT_BYTES + 4, False, True)])
def test_pk401_shared_memory_over_the_cap(smem, opt_in, fires):
    plan = [Launch("merge_kernel", (1, 1, 1), (512, 1, 1), smem, opt_in)]
    assert _codes(kb.run([_entry(plan)])) == (["PK401"] if fires else [])


def test_pk401_counts_static_shared_memory():
    plan = tiling.plan_select(1, 128, 4, 8, "f32")[:1]
    (chunk,) = plan
    big = Launch(chunk.kernel, chunk.grid, chunk.block,
                 tiling.SMEM_BLOCK_BYTES - chunk.static_smem_bytes + 4,
                 True, chunk.static_smem_bytes)
    (f,) = kb.run([_entry([big])])
    assert f.code == "PK401" and "centroid_chunk_kernel" in f.message


@pytest.mark.parametrize("block,grid", [((1025, 1, 1), (1, 1, 1)),
                                        ((100, 1, 1), (1, 1, 1)),
                                        ((256, 1, 1), (1, 70_000, 1)),
                                        ((256, 1, 1), (0, 1, 1)),
                                        ((32, 32, 2), (1, 1, 1))])
def test_pk402_block_and_grid_limits(block, grid):
    plan = [Launch("embedding_bag_kernel", grid, block, 0, False)]
    assert _codes(kb.run([_entry(plan)])) == ["PK402"]


def test_a_full_block_and_grid_are_fine():
    plan = [Launch("embedding_bag_kernel", (2 ** 31 - 1, 65_535, 65_535),
                   (32, 32, 1), 0, False)]
    assert kb.run([_entry(plan)]) == []


@pytest.mark.parametrize("lmax", [128, 300, 702, 1024, 1100])
@pytest.mark.parametrize("b,r_pad", [(1, 64), (25, 64), (2, 16), (1, 256)])
def test_adc_plan_fits_a_block_at_every_depth(lmax, b, r_pad):
    """The ADC scan's plan at 1, 3, 6, 8 and 9 slices a list (Lmax 128 to
    1,100), B 1 to 25 and r_pad 16 to 256: one block a (query, probed
    list, slice), its shared memory (the LUT, the fold over it, from
    ``ADC_BULK_MIN_B`` queries the mbarrier of the LUT's bulk copy)
    within the opt-in cap, the
    merge after it only past one slice's width, and the kernels pass
    accepts every launch."""
    plan = tiling.plan_adc(b, 64, lmax, 48, 256, r_pad)
    scan = plan[0]
    assert scan.kernel == "adc_scan_kernel"
    assert scan.grid == (64 * tiling.pq_split(lmax), b, 1)
    assert scan.static_smem_bytes == 3 * tiling.PQ_ROWS * 4 + (
        tiling.ADC_BULK_SMEM if b >= tiling.ADC_BULK_MIN_B else 0)
    assert scan.smem_bytes <= tiling.SMEM_BLOCK_BYTES
    assert (len(plan) == 1) == tiling.scan_fold(64, lmax, r_pad)
    for x in plan:
        assert kb.check_smem(x, "adc") == [] and \
            kb.check_shape(x, "adc") == []
    assert kb.run([_entry(plan)]) == []


def test_served_pq_plans_launch_the_adc_kernel_once(no_build):
    """At the served shape (nprobe 64, Lmax 702, m = 48 x 256, re-rank
    depth 64, B = 1 and 25) rows 3, 7 and 5 launch the ADC kernel once,
    last, with the LUT's 49,152 B of dynamic shared memory (the fold's 64
    lists of 64 fit over it), and the plan recorded on meta tensors says
    the same."""
    assert tiling.lut_bytes(48, 256) == 64 * 64 * 12 == 49_152
    for b in (1, 25):
        plans = [tiling.plan_adc(b, 64, 702, 48, 256, 64),
                 tiling.plan_fused_scan_pq(b, 64, 702, 48, 256, 768, 64,
                                           True, "f32"),
                 tiling.plan_fused_turn_pq(b, 16_384, 64, 64, 702, 48, 256,
                                           768, "f32", 64)]
        for plan in plans:
            adc = [x for x in plan if x.kernel == "adc_scan_kernel"]
            assert len(adc) == 1 and adc[0] is plan[-1]
            assert adc[0].grid == (384, b, 1)
            assert adc[0].dyn_smem_bytes == 49_152
    probe = kb.Probe("pq", (kb.Arg((1, 48, 256)),
                            kb.Arg((80, 702, 48), torch.uint8, 0, 256),
                            kb.Arg((80, 702), torch.int32, -1, 100),
                            kb.Arg((1, 64), torch.int32, 0, 80)),
                     lambda t, c, li, sel, device: ops.pq_adc_scan(
                         t, c, li, sel, 64, device=device))
    assert kb.planned(probe, probe.tensors("meta"), "meta") == [
        ("adc_scan_kernel", (384, 1, 1), (256, 1, 1),
         49_152 + 3 * tiling.PQ_ROWS * 4)]


# ------------------------------------------------------------- hnsw_search

def _hnsw_room(d):
    """Words of shared memory a block has beside the query and the HNSW
    kernel's static arrays."""
    return (tiling.SMEM_BLOCK_BYTES - tiling.STATIC_SMEM["hnsw_search_kernel"]
            - d * 4) // 4


def _widest():
    """The widest query row ``check_hnsw`` admits."""
    d = 4
    while True:
        try:
            tiling.check_hnsw(d + 4, 1, 1, 1)
        except ValueError:
            return d
        d += 4


@pytest.mark.parametrize("ef", [1, 32, 64, 128, 256])
@pytest.mark.parametrize("degree", [1, 16, 32, 64, 256])
def test_hnsw_plan_fits_every_shape_check_hnsw_admits(ef, degree):
    """Over n from 1 to 2^31 - 32 and d from 4 to the widest row
    ``check_hnsw`` admits: the plan picks the smaller of the shared
    bitmap (ceil(n / 32) words) and the shared hash (visits x 20 / 11
    slots, visits = min(n, 1 + (4 ef + 16) degree)) that fits, else the
    global bitmap; its shared memory is what the kernel takes (static,
    the query, a shared set) and never past the block's 232,448 B; the
    words pass the kernel's own checks; an instance forced where it does
    not fit is refused."""
    for d in (4, 64, 768, _widest()):
        tiling.check_hnsw(d, ef, degree, 1)
        room = _hnsw_room(d)
        for n in (1, 600, 20_000, 1_000_000, 2_000_000, 8_841_823,
                  2 ** 31 - 32):
            bitmap = -(-n // 32)
            visits = min(n, 1 + (4 * ef + 16) * degree)
            sizes = {"bitmap": bitmap, "hash": -(-visits * 20 // 11)}
            fits = {v: w for v, w in sizes.items() if w <= room}
            kind, words = tiling.hnsw_visited(n, d, ef, degree)
            if fits:
                assert kind == min(fits, key=fits.get)
                assert words == fits[kind]
            else:
                assert (kind, words) == ("global", bitmap)
            if kind == "hash":
                assert words * 11 >= visits * 20 and words > visits
            else:
                assert words >= bitmap
            (plan,) = tiling.plan_hnsw_search(32, d, n, ef, degree)
            assert plan.kernel == "hnsw_search_kernel"
            assert plan.grid == (32, 1, 1) and plan.opt_in
            assert plan.dyn_smem_bytes == d * 4 + (
                0 if kind == "global" else words * 4)
            assert plan.smem_bytes <= tiling.SMEM_BLOCK_BYTES
            assert kb.check_smem(plan, "hnsw") == []
            for forced in tiling.HNSW_VISITED:
                if forced == "global" or forced in fits:
                    assert tiling.hnsw_visited(n, d, ef, degree, forced) == (
                        forced, bitmap if forced == "global"
                        else sizes[forced])
                else:
                    with pytest.raises(ValueError, match="does not fit"):
                        tiling.hnsw_visited(n, d, ef, degree, forced)


@pytest.mark.parametrize("n,ef,degree,kind", [
    (2_000, 256, 16, "bitmap"),          # the card tests' integer graph
    (20_000, 32, 32, "bitmap"),          # the smoke's graph, ef 32 / 64,
    (20_000, 64, 32, "bitmap"),          # and a first turn's up x ef
    (20_000, 128, 32, "bitmap"),
    (600_000, 64, 32, "hash"),
    (8_841_823, 32, 32, "hash"),         # the collection's 8.8 M docs
    (8_841_823, 64, 32, "hash"),
    (8_841_823, 128, 32, "hash"),
    (8_841_823, 256, 32, "global"),
    (8_841_823, 64, 256, "global"),      # the degree cap
    (2_000_000, 256, 32, "global"),
])
def test_hnsw_plan_picks_the_instance_at_served_shapes(n, ef, degree, kind):
    """d = 768: the shared bitmap while ceil(n / 32) words are fewer
    than the hash's slots (n up to 506,496 at ef = 64, deg 32), then the
    shared hash (15,828 slots, 63 KB, at ef = 64; 30,722 at ef = 128),
    the global bitmap where the hash's slots pass the block's room (ef
    256, or degree 256)."""
    assert tiling.hnsw_visited(n, 768, ef, degree)[0] == kind


def test_hnsw_plan_refuses_an_unknown_instance():
    with pytest.raises(ValueError, match="visited must be one of"):
        tiling.hnsw_visited(100, 768, 64, 32, "tree")


def test_the_pass_reaches_hnsw_search_at_each_instance(no_build,
                                                       monkeypatch):
    """The port's probes record an ``hnsw_search`` launch at every
    instance of the visited set, each with the plan ``tiling`` gives
    for its shapes."""
    chosen = []
    real = tiling.hnsw_visited

    def spy(*a, **kw):
        chosen.append(real(*a, **kw)[0])
        return real(*a, **kw)

    monkeypatch.setattr(tiling, "hnsw_visited", spy)
    for probe in kb.port_probes():
        if not probe.label.startswith("ops.hnsw_search"):
            continue
        (rec,) = kb.record(probe)
        assert rec.entry == "hnsw_search"
        assert kb.check_smem(rec.plan[0], probe.label) == []
    assert set(chosen) == set(tiling.HNSW_VISITED)


def test_the_pass_reaches_flash_attention_at_mla_width(no_build):
    """The port's MLA probe records one bf16 ``flash_attention`` launch at
    D = 192, Dv = 128: a wide instance of 4 warps, its two stages and
    query rows within a block's shared memory."""
    (probe,) = [p for p in kb.port_probes()
                if p.label == "ops.flash_attention[mla]"]
    (rec,) = kb.record(probe)
    assert rec.entry == "flash_attention_bf16"
    (launch,) = rec.plan
    assert launch.kernel == "flash_bf16_kernel" and launch.block == (128, 1, 1)
    assert launch.dyn_smem_bytes == tiling.attn_smem(192, 128, 4, "bf16")[1]
    assert kb.check_smem(launch, probe.label) == []


# ---------------------------------------------------------------- the CLI


def test_cli_clean_tree_exits_0(no_build, capsys):
    assert cli.main(["--select", "kernels"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s) from 1 pass(es)" in out
    assert out.count("launch(es) through") == 11 + len(kb.port_probes())


def test_cli_unknown_pass_exits_2(capsys):
    assert cli.main(["--select", "no-such-pass"]) == 2
    assert "unknown pass" in capsys.readouterr().err


def test_cli_lists_its_passes(capsys):
    assert cli.main(["--list-passes"]) == 0
    assert capsys.readouterr().out.split() == ["kernels"]
    assert sorted(analysis.all_passes()) == ["kernels"]


def test_cli_json(no_build, capsys):
    assert cli.main(["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["active"] == [] and doc["stale_baseline"] == []
    assert [p["label"] for p in doc["probes"]] == \
        [p.label for p in kb.default_probes() + kb.port_probes()]
    assert all(p["launches"] >= 1 for p in doc["probes"])


@pytest.fixture
def failing_probe(monkeypatch):
    def boom(device):
        raise RuntimeError("probe fixture")
    monkeypatch.setattr(kb, "default_probes",
                        lambda: [kb.Probe("fixture", (), boom)])


def test_cli_findings_exit_1_and_the_baseline_suppresses(failing_probe,
                                                          tmp_path, capsys):
    assert cli.main([]) == 1
    assert "PK400 fixture: kernel probe failed" in capsys.readouterr().out
    base = tmp_path / "baseline.txt"
    base.write_text("# suppress the fixture\n*PK400 fixture:*\n")
    assert cli.main(["--baseline", str(base)]) == 0
    assert "1 finding(s) suppressed" in capsys.readouterr().out


def test_cli_strict_fails_on_a_stale_entry(no_build, tmp_path, capsys):
    base = tmp_path / "baseline.txt"
    base.write_text("*PK499 nothing matches this*\n")
    assert cli.main(["--baseline", str(base)]) == 0
    assert cli.main(["--strict", "--baseline", str(base)]) == 2
    assert "stale baseline entry" in capsys.readouterr().out


def test_run_all_rejects_unknown_passes():
    with pytest.raises(ValueError, match="unknown pass"):
        analysis.run_all(["nope"])


def test_the_repository_baseline_is_read_and_empty(no_build):
    from repro_torch.analysis.project import repo_root
    path = repo_root() / "analysis-baseline.txt"
    assert path.is_file() and analysis.load_baseline(str(path)) == []
