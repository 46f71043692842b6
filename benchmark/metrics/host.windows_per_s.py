"""The windows the engine completed per second of the traced window, on
the host's clock: the rate over the run's rate interval (drive.py's
rate_interval: from the window's start to the last completion before
its deadline that ends a burst).  None where no burst ended in it."""


def read(rec):
    return rec.get("windows_per_s")
