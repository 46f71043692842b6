"""Milliseconds of the engine's `slab_dispatch` stage (RunStats.stage_seconds,
host clock) accrued in the traced window, per window completed in it."""


def read(rec):
    s = rec["stage_s"].get("slab_dispatch")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
