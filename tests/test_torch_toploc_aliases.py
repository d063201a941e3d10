"""The 18 deprecated ``toploc.*`` aliases of repro_torch == the reference's.

On the conftest ``small_corpus`` with the reference's IVF, IVF-PQ and
HNSW indexes converted by ``convert``, each alias (``ivf_*``,
``ivf_pq_*``, ``hnsw_*`` x start / step / start_batch / step_batch /
plain_batch / conversation) runs in both packages on the same
utterances:

* ids, session fields and every ``TurnStats`` counter exact, scores
  within 1e-5;
* each port alias ``torch.equal`` to the registry driver it forwards to;
* the warning text is the reference's, a ``DeprecationWarning`` once a
  call site, and the wrapper keeps ``__name__``, the reference's
  signature (plus ``device``) and the ``__deprecated_alias__`` marker;
* an alias with no ``device`` raises without CUDA.  (An HNSW alias past
  the kernel's caps raising on the card: ``test_torch_hnsw_cuda.py``.)

Everything runs on CPU tensors (the kernels' plain versions).
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import toploc as rtl
from repro_torch import convert
from repro_torch.core import backend as tbackend
from repro_torch.core import toploc as ttl

K, H, NPROBE, ALPHA, EF, UP = 10, 16, 4, 0.5, 16, 2
TOL = 1e-5
CPU = "cpu"
FAMILIES = ("ivf", "ivf_pq", "hnsw")
KINDS = ("start", "step", "start_batch", "step_batch", "plain_batch",
         "conversation")
ALIASES = [f"{fam}_{kind}" for fam in FAMILIES for kind in KINDS]


@pytest.fixture(autouse=True)
def fresh_sites():
    """Each test sees every call site warn anew, in both packages."""
    rtl._warned_sites.clear()
    ttl._warned_sites.clear()
    yield
    rtl._warned_sites.clear()
    ttl._warned_sites.clear()


@pytest.fixture(scope="module")
def indexes(ivf_index, ivf_pq_index, hnsw_index):
    """(reference index, port index) per family."""
    return {
        "ivf": (ivf_index, convert.ivf_index_from_numpy(
            *(np.asarray(f) for f in ivf_index), device=CPU)),
        "ivf_pq": (ivf_pq_index, convert.ivf_pq_index_from_numpy(
            *(np.asarray(f) for f in ivf_pq_index), device=CPU)),
        "hnsw": (hnsw_index, convert.hnsw_index_from_numpy(
            *(np.asarray(f) for f in hnsw_index[:5]), device=CPU)),
    }


def _knobs(fam, kind, mode="toploc"):
    """The alias's knobs: the reference's signature, defaults left out
    where the reference has them (``rerank``, ``up``, ``alpha``)."""
    if fam == "hnsw":
        kw = dict(ef=EF, k=K)
        if kind in ("start", "start_batch", "step_batch"):
            kw["up"] = UP
        if kind == "conversation":
            kw["mode"] = mode
        return kw
    kw = dict(nprobe=NPROBE, k=K)
    if kind in ("start", "start_batch", "conversation"):
        kw["h"] = H
    if kind in ("step", "step_batch", "conversation"):
        kw["alpha"] = ALPHA
    if kind == "conversation":
        kw["mode"] = mode
    return kw


def _drive(tl, fam, kind, index, convs, wrap, mode="toploc", **extra):
    """Run one alias in package ``tl`` on conversations ``convs`` (C, T,
    d); returns every output, turn by turn, as a flat list."""
    alias = getattr(tl, f"{fam}_{kind}")
    kw = dict(_knobs(fam, kind, mode), **extra)
    out = []
    if kind in ("start", "step"):
        start = getattr(tl, f"{fam}_start")
        skw = dict(_knobs(fam, "start"), **extra)
        for conv in convs:
            q = [wrap(u) for u in conv]
            if kind == "start":
                out.append(alias(index, q[0], **kw))
                continue
            _, _, sess, _ = start(index, q[0], **skw)
            for u in q[1:]:
                v, i, sess, st = alias(index, sess, u, **kw)
                out.append((v, i, sess, st))
        return out
    if kind in ("start_batch", "plain_batch"):
        return [alias(index, wrap(convs[:, 0]), **kw)]
    if kind == "step_batch":
        start = getattr(tl, f"{fam}_start_batch")
        skw = dict(_knobs(fam, "start_batch"), **extra)
        _, _, sess, _ = start(index, wrap(convs[:, 0]), **skw)
        for t in range(1, convs.shape[1]):
            v, i, sess, st = alias(index, sess, wrap(convs[:, t]), **kw,
                                   is_first=wrap(_first(convs, t)))
            out.append((v, i, sess, st))
        return out
    return [alias(index, wrap(conv), **kw) for conv in convs]


def _first(convs, t):
    """A mixed wave: turn t's ``is_first`` rows (a fresh array a turn;
    the port's counters may keep the tensor they were given)."""
    first = np.zeros(convs.shape[0], bool)
    first[t % convs.shape[0]] = True
    return first


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _same(ref, port, what):
    ref_l, port_l = list(_leaves(ref)), list(_leaves(port))
    assert len(ref_l) == len(port_l), what
    for n, (r, p) in enumerate(zip(ref_l, port_l)):
        r = np.asarray(r)
        p = p.numpy()
        assert r.shape == p.shape, (what, n)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, rtol=0, atol=TOL,
                                       err_msg=f"{what} leaf {n}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{what} leaf {n}")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*a, **kw)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_matches_reference(small_corpus, indexes, alias):
    fam, kind = _split(alias)
    rindex, tindex = indexes[fam]
    convs = small_corpus.conversations
    ref = _quiet(_drive, rtl, fam, kind, rindex, convs, jnp.asarray)
    port = _quiet(_drive, ttl, fam, kind, tindex, convs, _t, device=CPU)
    _same(ref, port, alias)


@pytest.mark.parametrize("fam,mode", [("ivf", "plain"), ("ivf_pq", "plain"),
                                      ("hnsw", "plain"),
                                      ("hnsw", "adaptive")])
def test_conversation_modes_match_reference(small_corpus, indexes, fam,
                                            mode):
    rindex, tindex = indexes[fam]
    convs = small_corpus.conversations
    ref = _quiet(_drive, rtl, fam, "conversation", rindex, convs,
                 jnp.asarray, mode=mode)
    port = _quiet(_drive, ttl, fam, "conversation", tindex, convs, _t,
                  mode=mode, device=CPU)
    _same(ref, port, f"{fam}_conversation[{mode}]")


def _split(alias):
    for fam in ("ivf_pq", "ivf", "hnsw"):
        if alias.startswith(fam + "_"):
            return fam, alias[len(fam) + 1:]
    raise ValueError(alias)


def _registry_backend(fam, kind, mode="toploc"):
    """The backend each alias builds, from the registry by hand."""
    kw = _knobs(fam, kind, mode)
    if fam == "hnsw":
        return tbackend.HNSWBackend(ef=EF, up=kw.get("up", 2),
                                    adaptive=mode == "adaptive")
    if fam == "ivf_pq":
        return tbackend.IVFPQBackend(h=H, nprobe=NPROBE, rerank=32,
                                     alpha=kw.get("alpha", -1.0))
    return tbackend.IVFBackend(h=H, nprobe=NPROBE,
                               alpha=kw.get("alpha", -1.0))


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_equals_its_registry_call(small_corpus, indexes, alias):
    """Bit for bit: each alias is its driver with the backend it names
    (``rerank`` and ``up`` at the reference's defaults, 32 and 2)."""
    fam, kind = _split(alias)
    _, index = indexes[fam]
    convs = small_corpus.conversations
    got = _quiet(_drive, ttl, fam, kind, index, convs, _t, device=CPU)
    be = _registry_backend(fam, kind)
    be0 = _registry_backend(fam, "start_batch" if kind == "step_batch"
                            else "start")
    want = []
    if kind in ("start", "step"):
        for conv in convs:
            q = _t(conv)
            if kind == "start":
                want.append(ttl.start(be, index, q[0], k=K, device=CPU))
                continue
            _, _, sess, _ = ttl.start(be0, index, q[0], k=K, device=CPU)
            for u in q[1:]:
                v, i, sess, st = ttl.step(be, index, sess, u, k=K,
                                          device=CPU)
                want.append((v, i, sess, st))
    elif kind in ("start_batch", "plain_batch"):
        want.append(getattr(ttl, kind)(be, index, _t(convs[:, 0]), k=K,
                                       device=CPU))
    elif kind == "step_batch":
        _, _, sess, _ = ttl.start_batch(be0, index, _t(convs[:, 0]), k=K,
                                        device=CPU)
        for t in range(1, convs.shape[1]):
            v, i, sess, st = ttl.step_batch(be, index, sess, _t(convs[:, t]),
                                            k=K, is_first=_t(_first(convs, t)),
                                            device=CPU)
            want.append((v, i, sess, st))
    else:
        want = [ttl.conversation(be, index, _t(conv), k=K, device=CPU)
                for conv in convs]
    g, w = list(_leaves(got)), list(_leaves(want))
    assert len(g) == len(w)
    assert all(torch.equal(a, b) for a, b in zip(g, w)), alias


def test_warning_text_once_per_call_site(small_corpus, indexes):
    rindex, tindex = indexes["ivf"]
    q = small_corpus.conversations[0, 0]
    msgs = {}
    for name, tl, index, qv, extra in (
            ("ref", rtl, rindex, jnp.asarray(q), {}),
            ("port", ttl, tindex, _t(q), {"device": CPU})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):      # one line, two calls: one warning
                tl.ivf_start(index, qv, h=H, nprobe=NPROBE, k=K, **extra)
            tl.ivf_start(index, qv, h=H, nprobe=NPROBE, k=K, **extra)
            tl.ivf_plain_batch(index, qv[None], nprobe=NPROBE, k=K, **extra)
        msgs[name] = [(w.category, str(w.message), w.filename)
                      for w in caught]
    assert msgs["port"] == msgs["ref"]
    assert [m for _, m, _ in msgs["port"]] == [
        "toploc.ivf_start is deprecated; use the core.backend registry: "
        "start(IVFBackend(h=…, nprobe=…), …)"] * 2 + [
        "toploc.ivf_plain_batch is deprecated; use the core.backend "
        "registry: plain_batch(IVFBackend(…), …)"]
    assert all(c is DeprecationWarning and f == __file__
               for c, _, f in msgs["port"])


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_keeps_name_marker_and_signature(alias):
    import inspect
    fn, ref = getattr(ttl, alias), getattr(rtl, alias)
    assert fn.__name__ == alias and fn.__deprecated_alias__ is True
    params = dict(inspect.signature(fn).parameters)
    assert params.pop("device").default is None
    want = inspect.signature(ref).parameters
    assert [(n, p.kind, p.default) for n, p in params.items()] == \
        [(n, p.kind, p.default) for n, p in want.items()]


def test_aliases_default_to_cuda(indexes, small_corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, tindex = indexes["ivf"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(ttl.ivf_start, tindex, _t(small_corpus.conversations[0, 0]),
               h=H, nprobe=NPROBE, k=K)
