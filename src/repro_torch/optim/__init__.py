"""Optimizers of the training path: AdamW through the fused kernel.

``adafactor``, ``compress`` (top-k with error feedback) and
``ordered_reduce`` (the fixed-ring cross-device sum) of ``repro.optim``
are not ported yet (ROADMAP queue 1 item 12)."""

from repro_torch.optim.adamw import adamw_init, adamw_update

__all__ = ["adamw_init", "adamw_update"]
