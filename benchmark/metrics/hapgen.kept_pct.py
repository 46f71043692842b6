"""The share of the candidate haplotypes generated in the traced window
that survived the alignment to the reference and the removal of
duplicate reference haplotypes (RunStats counters `hapgen.haps_kept`
over `hapgen.haps_generated`), in percent.  None where the program lacks
the counters or generated none."""


def read(rec):
    c = rec.get("counts", {})
    base = c.get("hapgen.haps_generated")
    if not base or "hapgen.haps_kept" not in c:
        return None
    return 100.0 * c["hapgen.haps_kept"] / base
