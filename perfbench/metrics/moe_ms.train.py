"""moe_ms.train: device ms a step of the kernels launched under the
benchmark's ``perfbench.moe`` span around ``moe_apply`` (its forward, its
recompute under block remat and its backward); None without experts."""


def read(ctx):
    if not ctx["cfg"].get("num_experts"):
        return None
    s = ctx["trace"].kernel_s_under("moe")
    return s * 1e3 / ctx["steps"] if s > 0 else None
