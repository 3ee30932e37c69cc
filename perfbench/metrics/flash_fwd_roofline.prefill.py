"""flash_fwd_roofline.prefill: the flash forward's roofline bounds summed
over the profiled prefills (a launch a layer), over the device time of
the forward kernels (``flash_attention_*``) launched in their spans."""
from perfbench.bench import costs


def read(ctx):
    c, t = ctx["cfg"], ctx["trace"]
    busy = sum(t.kernel_s_named("flash_attention_", lo=a, hi=b)
               for a, b in t.named_ranges("prefill"))
    if busy <= 0:
        return None
    bound = sum(costs.flash_fwd_bound_s(
        B, S, c["num_attention_heads"], c["num_key_value_heads"],
        c["head_dim"]) for B, S in ctx["batches"])
    return 100.0 * bound * c["num_hidden_layers"] / busy
