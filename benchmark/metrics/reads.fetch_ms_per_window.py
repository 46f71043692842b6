"""Milliseconds of the engine's `get_reads.fetch` stage (RunStats.stage_seconds,
host clock): the native BAM fetch (BGZF inflate, record decode) inside
get_reads, accrued in the traced window, per window completed in it.
None where the program has no such stage."""


def read(rec):
    s = rec["stage_s"].get("get_reads.fetch")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
