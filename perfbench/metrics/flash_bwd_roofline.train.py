"""flash_bwd_roofline.train: the flash backward's (5b) roofline bound at
the cell's shape, a launch a layer a step, over the device time of its
kernels (``flash_bwd_*``) in the profiled steps; None if none ran."""
from perfbench.bench import costs


def read(ctx):
    c, tr = ctx["cfg"], ctx["traffic"]
    t = ctx["trace"]
    lo, hi = ctx["window"]
    busy = t.kernel_s_named("flash_bwd_", lo=lo, hi=hi)
    if busy <= 0:
        return None
    bound = costs.flash_bwd_bound_s(
        tr["batch"], tr["seq_len"], c["num_attention_heads"],
        c["num_key_value_heads"], c["head_dim"])
    return 100.0 * bound * c["num_hidden_layers"] * ctx["steps"] / busy
