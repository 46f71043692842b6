"""Milliseconds of the engine's `hapgen.hapdist` stage
(RunStats.stage_seconds, host clock): the native haplotype distribution
(make_hapdist, insert_reads, set_frequencies) inside hapgen, accrued in
the traced window, per window completed in it.  None where the program
has no such stage."""


def read(rec):
    s = rec["stage_s"].get("hapgen.hapdist")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
