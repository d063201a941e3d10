"""Sharding rules: the model specs and the index placement specs.

Port of ``repro/distributed/sharding.py``: the axis binding ``Axes`` /
``from_mesh``, the per-architecture parameter, batch, cache and
optimizer specs (``:62-293``) and the specs of the three retrieval
indexes (``:295-341``).  A spec is a ``P`` per leaf, one entry per
dimension: the mesh axis (or tuple of axes) that dimension is split
over, or None.

Conventions (the reference's):
  * ``tp``   the ``model`` mesh axis: tensor-parallel dims (attention
    heads, FFN hidden, vocab, embedding-table rows, posting lists);
  * ``fsdp`` the data axes (``("data",)`` on one pod, ``("pod",
    "data")`` on two): parameter and optimizer sharding;
  * a batch always splits over the data axes;
  * decode KV caches split the *sequence* dim over ``model``: kv-head
    counts (8, 20, 4, ...) do not divide a 16-wide model axis, the
    sequence always does.

The spec builders keep the reference's tree structure and keys, the LM
``layers`` leaves with the reference's leading layer axis (it scans
over stacked layers); ``module_specs`` attaches a spec to every
parameter of a port module by the path ``convert.*_params_from_numpy``
follows, dropping that leading entry where the port holds one module a
layer.  The dry-run (``launch.dryrun``) reads them for per-device bytes
and collectives, and ``distributed.elastic.replace_on_mesh`` places
trees by them.  Across a process group nothing uses them yet: that is
the multi-process half of training (ROADMAP Queue 1, item 7).

An index field whose spec names no axis lies whole on the replica's
leader device (the reference replicates it over the mesh); the port
runs the session math and the merges there, so one copy is all it
reads.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch


class P(tuple):
    """A partition spec: per dimension, the mesh axis it is split over
    (None: not split), the counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical → mesh axis binding.

    ``replica`` names the serving tier's replica axis of a 2-D
    ``(replica, shard)`` retrieval mesh (None on 1-D meshes).  The index
    specs never name it: every replica group holds a whole sharded
    corpus.
    """
    data: Tuple[str, ...] = ("data",)
    model: str = "model"
    replica: Optional[str] = None

    @property
    def dp(self):                  # batch / fsdp axes
        return self.data if len(self.data) > 1 else self.data[0]


def from_mesh(mesh) -> Axes:
    names = mesh.axis_names
    data = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else names[-1]
    return Axes(data=data, model=model,
                replica="replica" if "replica" in names else None)


def is_spec(x) -> bool:
    """A spec tree's leaf: a ``P`` or None (unspecified: replicated)."""
    return x is None or isinstance(x, P)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one dimension's spec entry names (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree of dicts / lists and trees of
    the same structure (``jax.tree.map`` with a spec as a leaf)."""
    if is_spec(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def spec_leaves(specs) -> List[Optional[P]]:
    """The spec leaves in tree order."""
    out: List[Optional[P]] = []
    map_specs(lambda s: out.append(s), specs)
    return out


# ---------------------------------------------------------------------------
# LM transformer
# ---------------------------------------------------------------------------


def lm_param_specs(cfg, ax: Axes) -> Dict[str, Any]:
    """The LM's parameter specs; ``layers`` leaves carry the reference's
    leading layer axis (None)."""
    dp, tp = ax.dp, ax.model
    n = P(None)

    def attn_specs() -> Dict[str, Any]:
        if cfg.attn_kind == "mla":
            return {
                "wq": P(None, dp, tp),
                "w_dkv": P(None, dp, None),
                "w_krope": P(None, dp, None),
                "w_uk": P(None, None, tp),
                "w_uv": P(None, None, tp),
                "kv_norm": {"scale": P(None, None)},
                "wo": P(None, tp, dp),
            }
        s: Dict[str, Any] = {
            "wq": P(None, dp, tp),
            "wk": P(None, dp, tp),
            "wv": P(None, dp, tp),
            "wo": P(None, tp, dp),
        }
        if cfg.qkv_bias:
            s["bq"] = P(None, tp)
            s["bk"] = P(None, tp)
            s["bv"] = P(None, tp)
        if cfg.qk_norm:
            s["q_norm"] = {"scale": P(None, None)}
            s["k_norm"] = {"scale": P(None, None)}
        return s

    layer: Dict[str, Any] = {
        "norm_attn": {"scale": P(None, None)},
        "norm_mlp": {"scale": P(None, None)},
        "attn": attn_specs(),
    }
    if cfg.is_moe:
        layer["moe"] = {
            "router": P(None, dp, None),
            "w_gate": P(None, None, dp, tp),
            "w_up": P(None, None, dp, tp),
            "w_down": P(None, None, tp, dp),
        }
        if cfg.n_shared:
            layer["moe"]["shared"] = {
                "w_gate": P(None, dp, tp),
                "w_up": P(None, dp, tp),
                "w_down": P(None, tp, dp),
            }
    else:
        layer["mlp"] = {
            "w_gate": P(None, dp, tp),
            "w_up": P(None, dp, tp),
            "w_down": P(None, tp, dp),
        }

    return {
        "embed": P(tp, dp),
        "layers": layer,
        "final_norm": {"scale": n},
        "lm_head": P(dp, tp),
    }


def lm_batch_specs(ax: Axes) -> Dict[str, Any]:
    return {"tokens": P(ax.dp, None), "labels": P(ax.dp, None)}


def lm_cache_specs(cfg, ax: Axes, shard_batch: bool = True
                   ) -> Dict[str, Any]:
    """shard_batch=False: a batch too small to split (long_500k's B = 1);
    the sequence dim still splits over the model axis."""
    dp, tp = (ax.dp if shard_batch else None), ax.model
    if cfg.attn_kind == "mla":
        return {"ckv": P(None, dp, tp, None),
                "krope": P(None, dp, tp, None)}
    # (L, B, Hkv, S, dh): sequence over tp
    return {"k": P(None, dp, None, tp, None),
            "v": P(None, dp, None, tp, None)}


def adafactor_factored(shape) -> bool:
    """Adafactor's factoring rule (``optim.optimizers.Adafactor``): both
    trailing dims >= 128."""
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def lm_opt_specs(opt_name: str, param_specs, param_structs=None) -> Any:
    """Optimizer-state specs mirror the parameter specs (moments split
    like weights).  Adafactor factors by shape (``adafactor_factored``),
    so its tree consults ``param_structs`` (anything with a ``shape``
    per leaf, in the spec tree's structure) for which leaves carry
    factored (vr, vc) and which a full v."""
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    if opt_name == "sgd":
        return {"m": param_specs, "step": P()}
    if opt_name == "adafactor":
        if param_structs is None:
            raise ValueError("adafactor specs need param shapes (pass "
                             "param_structs)")

        def factored(spec, struct):
            parts = tuple(spec) if isinstance(spec, P) else ()
            shape = tuple(struct.shape)
            parts = parts + (None,) * (len(shape) - len(parts))
            if adafactor_factored(shape):
                return {"vr": P(*parts[:-1]),
                        "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": P(*parts)}

        return {"v": map_specs(factored, param_specs, param_structs),
                "step": P()}
    raise ValueError(opt_name)


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------


def replicate_specs(tree) -> Any:
    """P() for every leaf of a tree of dicts / lists (a ``P`` is a
    leaf)."""
    if isinstance(tree, dict):
        return {k: replicate_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P) \
            and not hasattr(tree, "_fields"):
        return type(tree)(replicate_specs(v) for v in tree)
    return P()


def gin_param_specs(params: Any) -> Any:
    """GIN's parameters are tiny (~100 k): replicate everything."""
    return replicate_specs(params)


def gin_batch_specs(ax: Axes, *, full_graph: bool, batched: bool = False
                    ) -> Dict[str, Any]:
    flat = ax.data + (ax.model,)
    if batched:                      # molecule: batch over everything
        return {"x": P(ax.dp), "edge_src": P(ax.dp), "edge_dst": P(ax.dp),
                "node_mask": P(ax.dp), "edge_mask": P(ax.dp),
                "labels": P(ax.dp)}
    if full_graph:                   # edges split over the whole mesh
        return {"x": P(), "edge_src": P(flat), "edge_dst": P(flat),
                "labels": P(), "train_mask": P(), "edge_mask": P(flat)}
    # sampled minibatch: node / edge sets split over the data axes
    return {"x": P(ax.dp), "edge_src": P(ax.dp), "edge_dst": P(ax.dp),
            "labels": P(ax.dp), "seed_mask": P(ax.dp),
            "edge_mask": P(ax.dp)}


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


def _mlp_specs(n_layers: int, dp, tp, alt: bool = True) -> Dict[str, Any]:
    """Tower MLP: the hidden dim alternately over tp (the Megatron
    two-layer pattern)."""
    layers = []
    for i in range(n_layers):
        w = P(None, tp) if (i % 2 == 0 and alt) else P(tp, None)
        b = P(tp) if (i % 2 == 0 and alt) else P(None)
        layers.append({"w": w, "b": b})
    return {"layers": layers}


def two_tower_param_specs(cfg, ax: Axes) -> Any:
    dp, tp = ax.dp, ax.model
    nt = len(cfg.tower_mlp)
    return {
        "emb": {"table": P(tp, None)},
        "user_mlp": _mlp_specs(nt, dp, tp),
        "item_mlp": _mlp_specs(nt, dp, tp),
    }


def dcnv2_param_specs(cfg, ax: Axes) -> Any:
    dp, tp = ax.dp, ax.model
    return {
        "emb": {"table": P(tp, None)},
        # cross layers are (d_input, d_input) with d_input = 13 + 26·16 =
        # 429: not divisible by the model axis, and tiny (~184 k
        # parameters): replicated
        "cross": [{"w": P(None, None), "b": P(None)}
                  for _ in range(cfg.n_cross_layers)],
        "deep": _mlp_specs(len(cfg.mlp), dp, tp),
        "head": P(None, None),
    }


def bst_param_specs(cfg, ax: Axes) -> Any:
    dp, tp = ax.dp, ax.model
    blocks = [{
        "attn": {"wq": P(None, tp), "wk": P(None, tp), "wv": P(None, tp),
                 "wo": P(tp, None)},
        "norm1": {"scale": P(None), "bias": P(None)},
        "norm2": {"scale": P(None), "bias": P(None)},
        "ff": {"layers": [{"w": P(None, tp), "b": P(tp)},
                          {"w": P(tp, None), "b": P(None)}]},
    } for _ in range(cfg.n_blocks)]
    return {
        "emb": {"table": P(tp, None)},
        "other_emb": {"table": P(tp, None)},
        "pos": P(None, None),
        "blocks": blocks,
        "deep": _mlp_specs(len(cfg.mlp), dp, tp),
        "head": P(None, None),
    }


def autoint_param_specs(cfg, ax: Axes) -> Any:
    tp = ax.model
    layers = [{"wq": P(None, tp), "wk": P(None, tp), "wv": P(None, tp),
               "wres": P(None, tp)} for _ in range(cfg.n_attn_layers)]
    return {
        "emb": {"table": P(tp, None)},
        "attn": layers,
        "head": P(None, None),
    }


# ---------------------------------------------------------------------------
# bi-encoder (the paper's Dragon / Snowflake)
# ---------------------------------------------------------------------------


def encoder_param_specs(cfg, ax: Axes) -> Any:
    dp, tp = ax.dp, ax.model
    tower = {
        "embed": P(tp, dp),
        "pos": P(None, None),
        "layers": {
            "attn": {"wq": P(None, dp, tp), "wk": P(None, dp, tp),
                     "wv": P(None, dp, tp), "wo": P(None, tp, dp)},
            "norm1": {"scale": P(None, None)},
            "norm2": {"scale": P(None, None)},
            "mlp": {"w_gate": P(None, dp, tp), "w_up": P(None, dp, tp),
                    "w_down": P(None, tp, dp)},
        },
        "final_norm": {"scale": P(None)},
        "proj": P(dp, None),
    }
    return {"query": tower, "doc": tower}


# ---------------------------------------------------------------------------
# a spec for every parameter of a port module
# ---------------------------------------------------------------------------

# a port module's parameter name -> the reference tree's path
_RENAMES = (
    (re.compile(r"(^|\.)weights\.(\d+)$"), r"\1layers.\2.w"),
    (re.compile(r"(^|\.)biases\.(\d+)$"), r"\1layers.\2.b"),
    (re.compile(r"^table$"), "emb.table"),
    (re.compile(r"^other_table$"), "other_emb.table"),
    (re.compile(r"^cross_([wb])\.(\d+)$"), r"cross.\2.\1"),
    (re.compile(r"^(wq|wk|wv|wres)\.(\d+)$"), r"attn.\2.\1"),
    (re.compile(r"^mlps\.(\d+)\."), r"layers.\1.mlp."),
    (re.compile(r"^eps\.(\d+)$"), r"layers.\1.eps"),
)


def tree_path(name: str) -> str:
    """The reference tree's path of a port module's parameter ``name``
    (the path ``convert.*_params_from_numpy`` reads it from)."""
    for pat, rep in _RENAMES:
        name = pat.sub(rep, name)
    return name


def spec_at(spec_tree, name: str) -> Tuple[Any, bool]:
    """The spec node for parameter ``name`` of a port module, and whether
    its path stepped over a per-layer index of a stacked subtree (the
    LM's ``layers``: the node's leaves then carry a leading layer
    entry)."""
    node, stacked = spec_tree, False
    for part in tree_path(name).split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, (list, tuple)) and not is_spec(node) \
                and part.isdigit():
            node = node[int(part)]
        elif isinstance(node, dict) and part.isdigit():
            stacked = True           # one port module a stacked layer
        else:
            raise KeyError(f"{name}: no spec at {part!r} of "
                           f"{tree_path(name)}")
    return node, stacked


def module_specs(model: torch.nn.Module, spec_tree) -> Dict[str, P]:
    """A spec of its rank for every parameter of ``model``, by name
    (``named_parameters``): the tree's spec at the parameter's path, its
    leading layer entry dropped where the tree stacks layers, padded
    with None (unsplit) to the parameter's rank."""
    out = {}
    for name, p in model.named_parameters():
        spec, stacked = spec_at(spec_tree, name)
        if not is_spec(spec):
            raise KeyError(f"{name}: a subtree, not a spec, at "
                           f"{tree_path(name)}")
        parts = tuple(spec or ())[1 if stacked else 0:]
        if len(parts) > p.dim():
            raise ValueError(f"{name}: spec {parts} for a {p.dim()}-d "
                             f"parameter")
        out[name] = P(*(parts + (None,) * (p.dim() - len(parts))))
    return out


# ---------------------------------------------------------------------------
# retrieval indexes
# ---------------------------------------------------------------------------


def ivf_index_specs(ax: Axes) -> Any:
    """Centroids on the leader; posting lists split by partition over
    the model axis (each shard scans its own lists; the merge is one
    gather of k entries a shard, ``core.topk.distributed_topk_ordered``)."""
    from repro_torch.core.ivf import IVFIndex
    tp = ax.model
    return IVFIndex(
        centroids=P(None, None),
        list_vecs=P(tp, None, None),
        list_ids=P(tp, None),
        list_sizes=P(tp),
    )


def ivf_pq_index_specs(ax: Axes) -> Any:
    """IVF-PQ: coarse centroids and codebooks on the leader (small, read
    every turn); code lists split by partition like the float lists;
    the exact re-rank corpus split by document row, so each device
    holds 1/S of the floats (the owner computes the re-rank dot, the
    sum over shards merges)."""
    from repro_torch.core.pq import IVFPQIndex
    tp = ax.model
    return IVFPQIndex(
        centroids=P(None, None),
        codewords=P(None, None, None),
        list_codes=P(tp, None, None),
        list_ids=P(tp, None),
        list_sizes=P(tp),
        doc_vecs=P(tp, None),
    )


def hnsw_index_specs(ax: Axes) -> Any:
    """HNSW: the vectors (4·d bytes a node) split by node row over the
    model axis; the adjacency, the entry point, the levels and the
    tombstones on the leader, where the traversal runs: only the
    scoring of candidates is distributed."""
    from repro_torch.core.hnsw import HNSWIndex
    tp = ax.model
    return HNSWIndex(
        vectors=P(tp, None),
        adj0=P(None, None),
        upper_adj=P(None, None, None),
        entry_point=P(),
        node_level=P(None),
        deleted=P(None),
    )


# ---------------------------------------------------------------------------
# a field split by rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shards:
    """A tensor split by rows over a mesh axis: shard s holds rows
    [s·per, min((s+1)·per, n)) (the last shard may be shorter, or empty)
    in ``parts[s]``, on shard s's device.

    ``whole`` is the unsharded tensor when every part is a view of it
    (shards that share its device: nothing was copied), else None;
    ``added`` counts the bytes the placement allocated (every part,
    where the parts are not views).  ``shape``,
    ``dtype`` and ``device`` (the leader's, shard 0's) read like a
    tensor's, so the backends' shape logic runs unchanged; indexing by
    a tensor of global ids gathers those rows onto the leader.
    """
    parts: Tuple[torch.Tensor, ...]
    per: int
    whole: Optional[torch.Tensor] = None
    added: int = 0

    @property
    def n(self) -> int:
        return sum(p.shape[0] for p in self.parts)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n,) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def bounds(self, s: int) -> Tuple[int, int]:
        """Global rows [lo, hi) of shard s."""
        lo = min(s * self.per, self.n)
        return lo, lo + self.parts[s].shape[0]

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` (any shape, each in [0, n)) on the leader, each
        copied from its owner."""
        if self.whole is not None:
            return self.whole[ids]
        out = None
        for s, part in enumerate(self.parts):
            if not part.shape[0]:
                continue
            lo, hi = self.bounds(s)
            loc = ids.to(part.device).long() - lo
            own = (loc >= 0) & (loc < hi - lo)
            rows = part[loc.clamp(0, hi - lo - 1)].to(self.device)
            own = own.to(self.device).reshape(
                own.shape + (1,) * (rows.dim() - own.dim()))
            out = rows if out is None else torch.where(own, rows, out)
        return out


def split_rows(x: torch.Tensor, devices) -> Shards:
    """``x`` split by rows over ``devices`` (one shard each), in blocks
    of ⌈n/S⌉ rows, the last shorter.  Where every shard lies on ``x``'s
    device each is a view of it (no copy).  Otherwise every shard is a
    tensor of its own: the ones elsewhere copied there, the ones on
    ``x``'s device cloned, so that no shard keeps the whole of ``x``
    alive and a device holds only its shards once ``x`` is dropped."""
    s = len(devices)
    n = x.shape[0]
    per = max(1, -(-n // s))
    views = [x[min(j * per, n):min((j + 1) * per, n)] for j in range(s)]
    if all(torch.device(dev) == x.device for dev in devices):
        return Shards(tuple(views), per, x, 0)
    parts = tuple(v.to(dev, copy=True) for v, dev in zip(views, devices))
    return Shards(parts, per, None,
                  sum(p.numel() * p.element_size() for p in parts))
