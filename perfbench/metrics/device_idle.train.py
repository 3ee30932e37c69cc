"""device_idle.train: the share of the profiled steps' window in which
no operation ran on the device (1 - the union of the device's
intervals over the window)."""


def read(ctx):
    t = ctx["trace"]
    lo, hi = ctx["window"]
    return 100.0 * (1.0 - t.busy_s(lo, hi) / ((hi - lo) / 1e6))
