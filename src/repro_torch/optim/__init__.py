"""Training's optimizers, schedules and gradient utilities.

  schedules   — ``warmup_cosine``, ``inverse_sqrt``, ``constant``: the
                learning rate as a function of the integer step
  optimizers  — ``AdamW``, ``Adafactor``, ``SGD`` (``torch.optim``
                subclasses computing the reference's formulas), ``make``,
                ``apply_updates``
  grad        — ``value_and_grad``, ``global_norm``,
                ``clip_by_global_norm``, ``accumulate``, the int8
                error-feedback ``compress`` / ``decompress`` /
                ``compressed_mean``
"""
from repro_torch.optim import grad, optimizers, schedules  # noqa: F401
