"""Milliseconds of the batched engine's finish worker (RunStats stages
`slab_fetch` and `calling`, host clock) accrued in the traced window, per
window completed in it."""


def read(rec):
    st = rec["stage_s"]
    if "calling" not in st or rec["windows"] <= 0:
        return None
    return 1e3 * (st.get("slab_fetch", 0.0) + st["calling"]) / rec["windows"]
