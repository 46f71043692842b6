"""Milliseconds of the batched engine's `batch_wait` stage
(RunStats.stage_seconds, host clock): the main thread waiting for the
finish worker's previous batch, accrued in the traced window, per window
completed in it.  None where the program has no such stage."""


def read(rec):
    s = rec["stage_s"].get("batch_wait")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
