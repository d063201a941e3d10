"""The port's model specs, meshes and input pipeline against the
reference's, on the CPU.

* Every bundle's ``in_specs`` / ``out_specs`` tree equals the reference
  bundle's leaf for leaf (axis tuples), every shape of the ten archs at
  smoke size and of yi-9b and deepseek-v2-lite-16b at full size, on both
  production meshes' axes; each spec builder alone too (the LM's
  parameter, batch, cache and optimizer specs, GIN's, ``_mlp_specs``,
  the recsys and encoder specs).
* ``module_specs`` gives every parameter of each port module a spec of
  its rank; ``lm_opt_specs`` zips the port's AdamW and Adafactor states
  (each state tensor has a spec of its rank, Adafactor's factored
  leaves the same as the port's optimizer factors).
* ``choose_mesh_shape`` equals the reference's for n = 1 ... 600, with
  ``multi_pod`` both ways; the production and debug meshes' shapes.
* ``replace_on_mesh`` on a (2, 4) debug mesh of the CPU device puts each
  block of the host array where its coordinates say, and a checkpoint
  restored onto meshes of other sizes gathers back to the saved array.
* ``batch_iterator`` equals the reference's draw for draw;
  ``shard_batch`` and ``Prefetcher`` behave as ``tests/test_data.py``
  checks the reference's.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get as rget
from repro.configs import list_archs as rlist
from repro.data import pipeline as RPL
from repro.distributed import elastic as RE
from repro.distributed import sharding as RSH
from repro.models import transformer as RT
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs import common as TC
from repro_torch.configs import encoders as TENC
from repro_torch.data import pipeline as PL
from repro_torch.distributed import elastic as E
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TF

CPU = torch.device("cpu")
AXES = [(SH.Axes(), RSH.Axes(), 16),
        (SH.Axes(data=("pod", "data")), RSH.Axes(data=("pod", "data")), 32)]
FULL = ("yi-9b", "deepseek-v2-lite-16b")


def norm(t):
    """A spec tree with both packages' specs as ("P", entries...)."""
    if t is None:
        return None
    if isinstance(t, (JP, P)):
        return ("P",) + tuple(t)
    if isinstance(t, dict):
        return {k: norm(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [norm(v) for v in t]
    raise TypeError(type(t))


def _cells():
    out = [(a, True) for a in rlist()] + [(a, False) for a in FULL]
    return out


@pytest.mark.parametrize("arch_id,smoke", _cells())
def test_bundle_specs_equal_the_reference(arch_id, smoke):
    t, r = TC.get(arch_id), rget(arch_id)
    cfg = t.make_smoke_config() if smoke else t.make_config()
    rcfg = r.make_smoke_config() if smoke else r.make_config()
    for shape in t.shapes:
        for ax, rax, n_dp in AXES:
            tb = t.build_bundle(cfg, shape, ax, n_dp=n_dp, smoke=smoke)
            rb = r.build_bundle(rcfg, shape, rax, n_dp=n_dp, smoke=smoke)
            assert norm(tb.in_specs) == norm(rb.in_specs), (shape, ax)
            assert norm(tb.out_specs) == norm(rb.out_specs), (shape, ax)
            assert tb.donate_argnums == rb.donate_argnums
            assert tb.kind == rb.kind
            # the arguments after the parameters (and optimizer state)
            rargs = rb.arg_structs[2:] if rb.kind == "train" \
                else rb.arg_structs[1:]
            got = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                               rargs)
            want = _struct_tree(tb.arg_structs)
            assert norm_structs(got) == want, (shape,)


def _struct_tree(t):
    if isinstance(t, TC.Struct):
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    if isinstance(t, dict):
        return {k: _struct_tree(v) for k, v in t.items()}
    return [_struct_tree(v) for v in t]


def norm_structs(t):
    if isinstance(t, tuple) and len(t) == 2 and isinstance(t[1], str):
        return (t[0], t[1].replace("bool", "bool"))
    if isinstance(t, dict):
        return {k: norm_structs(v) for k, v in t.items()}
    return [norm_structs(v) for v in t]


@pytest.mark.parametrize("arch_id", ["yi-9b", "qwen1.5-4b", "qwen3-14b",
                                     "grok-1-314b", "deepseek-v2-lite-16b"])
def test_lm_spec_builders_equal_the_reference(arch_id):
    t, r = TC.get(arch_id), rget(arch_id)
    cfg, rcfg = t.make_smoke_config(), r.make_smoke_config()
    for ax, rax, _ in AXES:
        ps, rps = SH.lm_param_specs(cfg, ax), RSH.lm_param_specs(rcfg, rax)
        assert norm(ps) == norm(rps)
        assert norm(SH.lm_batch_specs(ax)) == norm(RSH.lm_batch_specs(rax))
        for sb in (True, False):
            assert norm(SH.lm_cache_specs(cfg, ax, sb)) == norm(
                RSH.lm_cache_specs(rcfg, rax, sb))
        assert norm(SH.lm_opt_specs("adamw", ps)) == norm(
            RSH.lm_opt_specs("adamw", rps))
        assert norm(SH.lm_opt_specs("sgd", ps)) == norm(
            RSH.lm_opt_specs("sgd", rps))
        structs = jax.eval_shape(
            lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
        tstructs = TC.lm_param_structs(TF.init_params(cfg, 0, "meta"))
        assert norm(SH.lm_opt_specs("adafactor", ps, tstructs)) == norm(
            RSH.lm_opt_specs("adafactor", rps, structs))


def test_other_spec_builders_equal_the_reference():
    for ax, rax, _ in AXES:
        for n in (1, 2, 3):
            assert norm(SH._mlp_specs(n, ax.dp, ax.model)) == norm(
                RSH._mlp_specs(n, rax.dp, rax.model))
        for arch_id, fn in (("two-tower-retrieval", "two_tower_param_specs"),
                            ("dcn-v2", "dcnv2_param_specs"),
                            ("bst", "bst_param_specs"),
                            ("autoint", "autoint_param_specs")):
            for smoke in (True, False):
                a = TC.get(arch_id)
                cfg = a.make_smoke_config() if smoke else a.make_config()
                r = rget(arch_id)
                rcfg = r.make_smoke_config() if smoke else r.make_config()
                assert norm(getattr(SH, fn)(cfg, ax)) == norm(
                    getattr(RSH, fn)(rcfg, rax)), arch_id
        for fg in (True, False):
            for bt in (True, False):
                assert norm(SH.gin_batch_specs(ax, full_graph=fg,
                                               batched=bt)) == norm(
                    RSH.gin_batch_specs(rax, full_graph=fg, batched=bt))
        for name in ("dragon", "snowflake"):
            cfg = getattr(TENC, f"{name}_config")()
            assert norm(SH.encoder_param_specs(cfg, ax)) == norm(
                RSH.encoder_param_specs(cfg, rax))
        assert ax.dp == rax.dp
    tree = {"a": [np.zeros(2), {"b": np.zeros(3)}]}
    assert norm(SH.gin_param_specs(tree)) == norm(
        RSH.gin_param_specs(tree))


_SPEC_FNS = {"two-tower-retrieval": SH.two_tower_param_specs,
             "dcn-v2": SH.dcnv2_param_specs, "bst": SH.bst_param_specs,
             "autoint": SH.autoint_param_specs}


@pytest.mark.parametrize("arch_id", sorted(rlist()))
def test_module_specs_cover_every_parameter(arch_id):
    a = TC.get(arch_id)
    cfg = a.make_smoke_config()
    bundle = a.build_bundle(cfg, a.shapes[0], smoke=True)
    model = bundle.init_model(0, "meta")
    specs = SH.module_specs(model, bundle.in_specs[0])
    names = [n for n, _ in model.named_parameters()]
    assert list(specs) == names
    for name, p in model.named_parameters():
        assert isinstance(specs[name], P) and len(specs[name]) == p.dim(), \
            (name, specs[name], p.shape)
    if arch_id in _SPEC_FNS:
        assert specs == SH.module_specs(model, _SPEC_FNS[arch_id](
            cfg, SH.Axes()))
    if a.family == "lm":
        # the LM's layer leaves carry the reference's leading layer entry
        assert specs["layers.0.attn.wq"] == P("data", "model")
        assert specs["embed"] == P("model", "data")


def test_module_specs_refuse_an_unknown_parameter():
    model = torch.nn.Linear(2, 2)
    with pytest.raises(KeyError):
        SH.module_specs(model, {"w": P()})


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_lm_opt_specs_zip_the_port_state(opt_name):
    import dataclasses
    # widths past Adafactor's 128 x 128 factoring threshold
    cfg = dataclasses.replace(TC.get("grok-1-314b").make_smoke_config(),
                              d_model=128, d_ff=256, moe_d_ff=256,
                              n_heads=8, n_kv_heads=2, d_head=16)
    model = TF.init_params(cfg, 0, "meta").requires_grad_(True)
    opt = TC.make_lm_optimizer(opt_name, list(model.parameters()))
    pspecs = SH.lm_param_specs(cfg, SH.Axes())
    ospecs = SH.lm_opt_specs(opt_name, pspecs,
                             TC.lm_param_structs(model))
    assert ospecs["step"] == P()
    n_factored = 0
    for name, p in model.named_parameters():
        state = {k: v for k, v in opt.state[p].items() if k != "step"}
        if opt_name == "adamw":
            nodes = {k: SH.spec_at(ospecs[k], name) for k in ("m", "v")}
        else:
            node, stacked = SH.spec_at(ospecs["v"], name)
            nodes = {k: (s, stacked) for k, s in node.items()}
        assert set(nodes) == set(state), name
        for k, (spec, stacked) in nodes.items():
            assert len(spec) - int(stacked) == state[k].dim(), (name, k)
        n_factored += "vr" in state
    assert (n_factored > 0) == (opt_name == "adafactor")


def test_choose_mesh_shape_equals_the_reference():
    for n in range(1, 601):
        for mp in (False, True):
            for pref in (16, 8):
                assert E.choose_mesh_shape(
                    n, preferred_model=pref, multi_pod=mp) == \
                    RE.choose_mesh_shape(n, preferred_model=pref,
                                         multi_pod=mp), (n, mp, pref)


def test_production_and_debug_meshes():
    m = M.make_production_mesh()
    assert (m.shape, m.axis_names, m.size) == (
        {"data": 16, "model": 16}, ("data", "model"), 256)
    mm = M.make_production_mesh(multi_pod=True)
    assert (mm.shape, mm.size) == ({"pod": 2, "data": 16, "model": 16}, 512)
    assert SH.from_mesh(mm) == SH.Axes(data=("pod", "data"))
    with pytest.raises(ValueError):
        m.device_at((0, 0))                  # logical: no devices
    d = M.make_debug_mesh((2, 4), devices=[CPU])
    assert d.shape == {"data": 2, "model": 4} and d.size == 8
    assert all(dev == CPU for dev in d.devices.reshape(-1))
    em = E.make_elastic_mesh(24, devices=[CPU, torch.device("meta")])
    assert em.shape == {"data": 2, "model": 12}
    assert em.device_at((0, 1)) == torch.device("meta")


def test_replace_on_mesh_puts_each_block_in_place():
    mesh = M.make_debug_mesh((2, 4), devices=[CPU])
    rng = np.random.default_rng(0)
    host = {"w": rng.normal(size=(8, 12)).astype(np.float32),
            "t": rng.normal(size=(6, 8, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32)]}
    specs = {"w": P("data", "model"), "t": P(None, ("data", "model")),
             "b": [P()]}
    placed = E.replace_on_mesh(host, specs, mesh)
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(
                placed["w"].blocks[(i, j)].numpy(),
                host["w"][4 * i:4 * i + 4, 3 * j:3 * j + 3])
            k = i * 4 + j                    # ("data", "model"): data major
            np.testing.assert_array_equal(
                placed["t"].blocks[(i, j)].numpy(), host["t"][:, k:k + 1])
            np.testing.assert_array_equal(placed["b"][0].blocks[(i, j)],
                                          host["b"][0])
    for leaf, want in ((placed["w"], host["w"]), (placed["t"], host["t"])):
        np.testing.assert_array_equal(leaf.gather().numpy(), want)
    # a block on the host array's own device is a view: nothing copied
    t = torch.from_numpy(host["w"])
    blk = E.place(t, P("data", None), mesh).blocks[(1, 0)]
    assert blk.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        E.replace_on_mesh({"w": np.zeros((3, 4))}, {"w": P("data")}, mesh)


def test_elastic_restore_across_mesh_sizes(tmp_path):
    """Save from one layout, restore and re-place on meshes of other
    sizes (the reference's ``test_elastic_restore_across_mesh_sizes``;
    the CPU device repeated stands in for the cards)."""
    d = str(tmp_path)
    params = {"w": torch.arange(16.0).reshape(4, 4)}
    C.save(d, 1, params)
    restored = C.restore(d, 1, {"w": torch.zeros(4, 4)})
    for n in (1, 2, 4, 8):
        mesh = E.make_elastic_mesh(n, preferred_model=2, devices=[CPU])
        for spec in (P(), P("data", "model"), P("model", None)):
            placed = E.replace_on_mesh(restored, {"w": spec}, mesh)
            np.testing.assert_array_equal(placed["w"].gather().numpy(),
                                          params["w"].numpy())


def test_batch_iterator_equals_the_reference():
    rng = np.random.default_rng(3)
    data = {"x": rng.normal(size=(37, 3)), "y": np.arange(37)}
    for kw in (dict(shuffle=True, seed=5), dict(shuffle=False),
               dict(shuffle=True, seed=1, drop_remainder=False)):
        a = PL.batch_iterator(data, 8, **kw)
        b = RPL.batch_iterator(data, 8, **kw)
        for _ in range(12):              # past two epochs
            x, y = next(a), next(b)
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_batch_iterator_epochs():
    data = {"x": np.arange(10), "y": np.arange(10) * 2}
    it = PL.batch_iterator(data, 4, shuffle=False)
    b1 = next(it)
    assert b1["x"].shape == (4,)
    np.testing.assert_array_equal(b1["y"], b1["x"] * 2)
    # drop_remainder: two batches per epoch, then wraps
    batches = [next(it) for _ in range(3)]
    assert all(b["x"].shape == (4,) for b in batches)


def test_prefetcher():
    it = iter(range(20))
    pf = PL.Prefetcher(it, depth=2)
    got = [next(pf) for _ in range(20)]
    assert got == list(range(20))
    pf.close()


def test_shard_batch():
    batch = {"x": np.arange(32.0).reshape(16, 2), "n": np.array(3)}
    one = PL.shard_batch(batch, None, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device == CPU
               for v in one.values())
    np.testing.assert_array_equal(one["x"].numpy(), batch["x"])
    mesh = M.make_debug_mesh((2, 4), devices=[CPU])
    placed = PL.shard_batch(batch, mesh)
    assert placed["x"].spec == P(("data",)) and placed["n"].spec == P()
    for (i, j), blk in placed["x"].blocks.items():
        np.testing.assert_array_equal(blk.numpy(), batch["x"][8 * i:8 * i + 8])
    np.testing.assert_array_equal(placed["x"].gather().numpy(), batch["x"])
    two = M.Mesh(("pod", "data", "model"), (2, 2, 2),
                 M.make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                                   devices=[CPU]).devices)
    p2 = PL.shard_batch(batch, two, lambda k, v: P())
    assert p2["x"].blocks[(1, 1, 1)].shape == (16, 2)
    p3 = PL.shard_batch(batch, two)
    assert p3["x"].spec == P(("pod", "data"))
    np.testing.assert_array_equal(p3["x"].blocks[(1, 0, 1)].numpy(),
                                  batch["x"][8:12])
