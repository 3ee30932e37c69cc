"""moe_experts_ms.train: device ms a step of the kernels launched innermost
under the program's own ``repro.moe.experts`` span in ``moe_apply``
(the expert products): its forward, its recompute under block remat and its
bracketed backward.  None where the program opens no such span."""
from perfbench.bench import program_spans


def read(ctx):
    s = program_spans.kernel_s_under(ctx["trace"], "moe.experts")
    return s * 1e3 / ctx["steps"] if s > 0 else None
