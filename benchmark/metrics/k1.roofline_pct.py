"""K1 (the pair-HMM DP kernel, csrc/pair_hmm_dp.cu): the sum of its
launches' bounds (roofline.dp_bound, from each launch's shapes) over the
sum of their device time in the profiler's trace, in percent."""


def read(rec):
    k = rec["kernels"]["pair_hmm_dp"]
    if k["device_s"] <= 0 or k["bound_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
