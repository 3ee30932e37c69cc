"""decode_attn_roofline.decode: the populated K and V of every sequence
and layer, in bf16, read once in each profiled decode step (kv_len = S
+ j + 1 at step j, as ``hbm_roofline.decode`` counts it), at 3.35 TB/s,
over the device time of the kernels launched innermost under the
program's own ``repro.attention.core`` span within its ``repro.decode``
spans.  None where the program opens no such span."""
from perfbench.bench import costs, program_spans


def read(ctx):
    s = program_spans.kernel_s_under(ctx["trace"], "attention.core",
                                     within="decode")
    if s <= 0:
        return None
    c = ctx["cfg"]
    row = 2 * 2 * c["num_key_value_heads"] * c["head_dim"]   # K, V bf16
    need = sum(c["num_hidden_layers"] * B * (S + j + 1) * row
               for B, S in ctx["batches"] for j in range(ctx["decode_steps"]))
    return 100.0 * need / costs.HBM_BYTES_PER_S / s
