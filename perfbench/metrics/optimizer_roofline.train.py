"""optimizer_roofline.train: the least bytes of the optimizer's update at
3.35 TB/s over the device time of the kernels launched innermost under
the program's own ``repro.optimizer`` span, a step.

The least bytes, counted from the configuration's leaves
(``weights.leaf_specs``): each master and its gradient (of the master's
type) read once and each master written once; each of Adafactor's
float32 state leaves (a matrix leaf's row and column means, any other
leaf's full second moment) read once and written once.  Any
implementation of the same update is held to the same bytes.  None
where the program opens no such span, or for another optimizer."""
import math

import torch

from perfbench.bench import costs, program_spans, weights


def update_bytes(cfg: dict) -> float:
    master = getattr(torch, cfg["port"]["master_dtype"]).itemsize
    tot = 0.0
    for _, shape, _, f32 in weights.leaf_specs(cfg):
        m = 4 if f32 else master
        tot += 3 * m * math.prod(shape)
        if len(shape) >= 2:
            state = (math.prod(shape[:-1])
                     + math.prod(shape[:-2] + shape[-1:]))
        else:
            state = math.prod(shape)
        tot += 2 * 4 * state
    return tot


def read(ctx):
    if ctx["cfg"]["port"]["optimizer"]["name"] != "adafactor":
        return None
    s = program_spans.kernel_s_under(ctx["trace"], "optimizer")
    if s <= 0:
        return None
    need = update_bytes(ctx["cfg"]) * ctx["steps"]
    return 100.0 * need / costs.HBM_BYTES_PER_S / s
