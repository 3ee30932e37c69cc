"""device_idle.prefill: the share of the profiled prefills' spans in
which no operation ran on the device."""


def read(ctx):
    busy, span = ctx["trace"].busy_in_ranges_s("prefill")
    return 100.0 * (1.0 - busy / span) if span > 0 else None
