"""mfu.train: the train step's model FLOPs (6 x matmul parameters x
tokens plus the causal attention, without remat's recompute) over the
profiled steps' time, as a share of the bf16 peak (989 TFLOP/s)."""
from perfbench.bench import costs


def read(ctx):
    tr = ctx["traffic"]
    flops = costs.train_step_flops(ctx["cfg"], tr["batch"], tr["seq_len"])
    return 100.0 * flops / ctx["step_s"] / costs.BF16_OPS_PER_S
