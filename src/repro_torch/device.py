"""Device resolution for the port's entry points.

Entry points (``ConversationalSearchEngine``, ``ivf.build``, the
``toploc`` drivers, ``kernels.ops``) run on ``cuda`` unless the caller
passes ``device="cpu"``.  With no argument on a machine without CUDA
they raise: the port never drifts to the CPU behind the caller's back.
``kernels.ops`` also takes ``device="meta"``: shapes without data, which
only the launch-plan recorder (``kernels.launcher.record_launches``)
accepts; every kernel refuses them outside it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda.

    Raises ``RuntimeError`` when cuda is asked for (explicitly or by
    default) and this machine has none.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = ("" if device is not None else
                " (no device given: entry points default to cuda; pass "
                "device='cpu' to run the plain PyTorch path)")
        raise RuntimeError(f"CUDA is not available{hint}")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require(device: DeviceLike, *tensors: Optional[torch.Tensor]
            ) -> torch.device:
    """Resolve ``device`` and check every given tensor lives on it."""
    dev = resolve(device)
    for t in tensors:
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"tensor on {t.device}, entry point runs on "
                             f"{dev}; move the inputs first")
    return dev
