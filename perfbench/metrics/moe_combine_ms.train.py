"""moe_combine_ms.train: device ms a step of the kernels launched innermost
under the program's own ``repro.moe.combine`` span in ``moe_apply``
(the dummy row, the weights, the gather and the sum over k): its forward, its recompute under block remat and its
bracketed backward.  None where the program opens no such span."""
from perfbench.bench import program_spans


def read(ctx):
    s = program_spans.kernel_s_under(ctx["trace"], "moe.combine")
    return s * 1e3 / ctx["steps"] if s > 0 else None
