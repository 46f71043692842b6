"""The share of the read-aheads settled in the traced window that a
window took (RunStats counters `reads.ahead_used` over itself plus
`reads.ahead_refetched`, the read-aheads discarded), in percent.  The
program counts a discarded read-ahead only when one happens, so a
missing `reads.ahead_refetched` is none; None where the program has no
read-ahead (`reads.ahead_used` missing) or settled none."""


def read(rec):
    c = rec.get("counts", {})
    if "reads.ahead_used" not in c:
        return None
    base = c["reads.ahead_used"] + c.get("reads.ahead_refetched", 0)
    if base <= 0:
        return None
    return 100.0 * c["reads.ahead_used"] / base
