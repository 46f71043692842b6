"""Milliseconds of the reads layer's read-ahead (`get_reads.ahead`: the
next window's record intake on the program's native thread, by that
thread's own clock, added when a window takes or discards it) accrued
in the traced window, per window completed in it.  Off the main thread,
it moves windows_per_s only where it exceeds the main thread's own time
for a window (the other stages' sum): the main thread then waits for it
in `get_reads.fetch`.  None where the program has no such stage."""


def read(rec):
    s = rec["stage_s"].get("get_reads.ahead")
    if s is None or rec["windows"] <= 0:
        return None
    return 1e3 * s / rec["windows"]
