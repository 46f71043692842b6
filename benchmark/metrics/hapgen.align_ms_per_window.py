"""Milliseconds of the engine's `hapgen.align` stage
(RunStats.stage_seconds, host clock): each haplotype's NW against the
reference and the removal of duplicate reference haplotypes inside
hapgen, accrued in the traced window, per window completed in it.  None
where the program has no such stage."""


def read(rec):
    s = rec["stage_s"].get("hapgen.align")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
