"""optimizer_ms.train: device ms a step of the kernels launched under
the benchmark's ``perfbench.optimizer`` span around the optimizer's
update."""


def read(ctx):
    s = ctx["trace"].kernel_s_under("optimizer")
    return s * 1e3 / ctx["steps"] if s > 0 else None
