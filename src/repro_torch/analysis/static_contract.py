"""Pass ``contract`` — the value contract of the registered backends.

Port of ``repro/analysis/static_contract.py``.  The reference needs its
backends hashable and array-free because each rides through ``jax.jit``
as a static argument.  The port has no ``jit`` and keeps the contract
for its own reasons: a backend is a knob object shared by threads (the
batched engine's flusher, the router's replicas) and rebuilt by
``distributed.retrieval.shard_backend`` with ``dataclasses.replace`` to
plug in a sharded scan.  Frozen, so no turn sees its knobs change;
hashed and compared by value, so equal configurations are equal keys
for any cache a caller keeps per backend; array-free, so ``replace``
and a comparison never touch device data.  Checked by
introspecting the live registry (import, construct, hash), never by
matching source:

  SC201  registered class is not a frozen dataclass
  SC202  instances are not hashable, or two equal default instances
         hash differently
  SC203  a field holds (or is annotated as) a ``torch.Tensor`` or a
         numpy array
  SC204  driver surface incomplete: ``plain_batch`` missing, stateful
         backends missing ``start``/``step``/``start_batch``/
         ``step_batch``/``session_template``, ``step_batch`` not
         accepting ``is_first``, or ``name``/``index_kwarg`` left at
         the base-class placeholder
  SC205  backend not constructible via ``make(name)`` with defaults
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Iterator, List, Optional, Type

import numpy as np
import torch

from repro_torch.analysis.findings import Finding

PASS_ID = "static-contract"

_STATEFUL_SURFACE = ("start", "step", "start_batch", "step_batch")


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _leaves(x: Any) -> Iterator[Any]:
    """The leaves of nested tuples, lists and dicts (a pytree's)."""
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _check_class(name: str, cls: type, base: type,
                 findings: List[Finding]) -> None:
    where = f"backend {name!r} ({cls.__module__}.{cls.__qualname__})"

    if not (dataclasses.is_dataclass(cls)
            and cls.__dataclass_params__.frozen):
        findings.append(Finding(
            PASS_ID, "SC201", "", 0,
            f"{where} must be a frozen dataclass: threads share it and "
            f"shard_backend rebuilds it with dataclasses.replace"))
        return  # downstream checks assume dataclass machinery

    # SC205 — default-constructible (make() with no knobs)
    try:
        inst = cls()
        inst2 = cls()
    except Exception as e:  # noqa: BLE001 - report, don't crash the pass
        findings.append(Finding(
            PASS_ID, "SC205", "", 0,
            f"{where} is not default-constructible: {e!r}"))
        return

    # SC202 — hashable and equality/hash-consistent across instances
    try:
        h1, h2 = hash(inst), hash(inst2)
    except TypeError as e:
        findings.append(Finding(
            PASS_ID, "SC202", "", 0,
            f"{where} is unhashable ({e}); no cache can key on it"))
    else:
        if inst != inst2 or h1 != h2:
            findings.append(Finding(
                PASS_ID, "SC202", "", 0,
                f"{where}: two default instances are not equal with equal "
                f"hashes — equal configurations would compare as "
                f"different backends"))

    # SC203 — array-free fields (values and annotations)
    for f in dataclasses.fields(cls):
        v = getattr(inst, f.name, None)
        if any(_is_array(x) for x in _leaves(v)):
            findings.append(Finding(
                PASS_ID, "SC203", "", 0,
                f"{where}: field `{f.name}` holds an array — device data "
                f"flows as an argument (the index, the queries), not on "
                f"the backend's knobs"))
        elif any(t in str(f.type) for t in ("Tensor", "ndarray")):
            findings.append(Finding(
                PASS_ID, "SC203", "", 0,
                f"{where}: field `{f.name}` is annotated as an array type; "
                f"backends must be array-free"))

    # SC204 — driver surface
    if getattr(cls, "name", "?") in ("?", "", None):
        findings.append(Finding(
            PASS_ID, "SC204", "", 0,
            f"{where}: ClassVar `name` left at the base placeholder"))
    if getattr(cls, "index_kwarg", "?") in ("?", "", None):
        findings.append(Finding(
            PASS_ID, "SC204", "", 0,
            f"{where}: ClassVar `index_kwarg` left at the base "
            f"placeholder — the engines cannot route an index to it"))

    if not callable(getattr(cls, "plain_batch", None)):
        findings.append(Finding(
            PASS_ID, "SC204", "", 0,
            f"{where}: missing `plain_batch` — every backend must serve "
            f"stateless batched turns"))
    if not callable(getattr(cls, "plain", None)):
        findings.append(Finding(
            PASS_ID, "SC204", "", 0, f"{where}: missing `plain`"))

    if getattr(cls, "stateful", True):
        for meth in _STATEFUL_SURFACE:
            impl = getattr(cls, meth, None)
            if impl is None or impl is getattr(base, meth, None):
                findings.append(Finding(
                    PASS_ID, "SC204", "", 0,
                    f"{where}: stateful backend does not override "
                    f"`{meth}`"))
        sb = getattr(cls, "step_batch", None)
        if sb is not None and sb is not getattr(base, "step_batch", None):
            try:
                params = inspect.signature(sb).parameters
            except (TypeError, ValueError):
                params = {}
            if "is_first" not in params:
                findings.append(Finding(
                    PASS_ID, "SC204", "", 0,
                    f"{where}: `step_batch` does not accept `is_first` — "
                    f"the batched engine cannot route first turns through "
                    f"it"))
        st = getattr(cls, "session_template", None)
        if st is None or st is getattr(base, "session_template", None):
            findings.append(Finding(
                PASS_ID, "SC204", "", 0,
                f"{where}: stateful backend does not override "
                f"`session_template` — SessionStore cannot size its slab"))


def run(project=None,
        registry: Optional[Dict[str, type]] = None,
        base: Optional[type] = None) -> List[Finding]:
    """Check every registered backend (or an injected ``registry``)."""
    from repro_torch.core import backend as _backend
    reg: Dict[str, Type] = (dict(registry) if registry is not None
                            else dict(_backend._REGISTRY))
    base_cls = base if base is not None else _backend.RetrievalBackend
    findings: List[Finding] = []
    for name in sorted(reg):
        _check_class(name, reg[name], base_cls, findings)
    return findings
