"""The share of the BAM records the reads layer decoded in the traced
window that it kept as reads for a window (RunStats counters
`reads.kept` over `reads.records_fetched`), in percent.  None where the
program lacks the counters or decoded nothing."""


def read(rec):
    c = rec.get("counts", {})
    base = c.get("reads.records_fetched")
    if not base or "reads.kept" not in c:
        return None
    return 100.0 * c["reads.kept"] / base
