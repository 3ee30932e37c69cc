"""device_idle.decode: the share of the profiled decode steps' spans in
which no operation ran on the device."""


def read(ctx):
    busy, span = ctx["trace"].busy_in_ranges_s("decode")
    return 100.0 * (1.0 - busy / span) if span > 0 else None
