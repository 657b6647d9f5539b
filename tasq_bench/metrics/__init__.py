"""One reader a per-layer metric, found by the metric's name:
``read(ctx) -> float | None`` over what the traced run recorded
(``ctx.traced``); None where the run gives it nothing to read."""
