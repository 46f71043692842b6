"""The share of the traced window in which no kernel, copy or memset ran
on the device (the union of their intervals in the profiler's trace), in
percent."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
