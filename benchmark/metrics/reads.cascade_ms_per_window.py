"""Milliseconds of the engine's `get_reads.cascade` stage
(RunStats.stage_seconds, host clock): the filter cascade inside
get_reads, the survivors' Reads built, accrued in the traced window, per
window completed in it.  None where the program has no such stage."""


def read(rec):
    s = rec["stage_s"].get("get_reads.cascade")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
