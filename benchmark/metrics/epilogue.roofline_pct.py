"""The slab epilogue (csrc/slab_epilogue.cu: K2 finish, K3 pair_stats,
K4 window_call): the sum of their launches' bounds (roofline.py) over
the sum of their device time in the profiler's trace, in percent."""

KERNELS = ("finish", "pair_stats", "window_call")


def read(rec):
    ks = [rec["kernels"][k] for k in KERNELS]
    dev = sum(k["device_s"] for k in ks)
    bnd = sum(k["bound_s"] for k in ks)
    if dev <= 0 or bnd <= 0:
        return None
    return 100.0 * bnd / dev
