"""hbm_roofline.decode: the bytes the profiled decode steps must read
(every weight once, the populated K/V of each sequence) at 3.35 TB/s,
over the device's busy time inside their ``perfbench.decode`` spans (the
union of the operations that ran there; the host's gaps between them are
``device_idle.decode``'s)."""
from perfbench.bench import costs


def read(ctx):
    n = ctx["decode_steps"]
    need = sum(costs.decode_step_bytes(ctx["cfg"], B, S + j + 1)
               for B, S in ctx["batches"] for j in range(n))
    busy, _ = ctx["trace"].busy_in_ranges_s("decode")
    if busy <= 0:
        return None
    return 100.0 * need / costs.HBM_BYTES_PER_S / busy
