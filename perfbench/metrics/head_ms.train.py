"""head_ms.train: device ms a step of the kernels launched innermost
under the program's own ``repro.head`` span (the final norm, the
unembedding and the chunked cross-entropy, forward and bracketed
backward from the loss to the last block's output).  None where the
program opens no such span."""
from perfbench.bench import program_spans


def read(ctx):
    s = program_spans.kernel_s_under(ctx["trace"], "head")
    return s * 1e3 / ctx["steps"] if s > 0 else None
