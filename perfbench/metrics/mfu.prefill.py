"""mfu.prefill: the profiled prefills' model FLOPs (2 x the blocks'
matmul parameters x tokens, the causal attention, each sequence's last
position unembedded) over the device's busy time inside their
``perfbench.prefill`` spans (the union of the operations that ran
there), as a share of the bf16 peak."""
from perfbench.bench import costs


def read(ctx):
    flops = sum(costs.prefill_flops(ctx["cfg"], B, S)
                for B, S in ctx["batches"])
    busy, _ = ctx["trace"].busy_in_ranges_s("prefill")
    return 100.0 * flops / busy / costs.BF16_OPS_PER_S if busy > 0 else None
