"""Per-step memory of chip_smoke.py's logical (1, 4) mesh train step
(phase 10: Qwen3-MoE's full-width layer, Adafactor, B 2 x 8,192): one
step off the mesh, then 3 under it, each step's allocated and reserved
peak, allocator retries and the segments with the most free space, one
JSON line a step.  On the card, for the tree at ROOT (this checkout, or
another commit's unpacked beside it):

    python3 scripts/mesh_step_memory.py ROOT TAG

``PYTORCH_CUDA_ALLOC_CONF`` is read from the environment as it is."""
import json, os, sys, time
root = os.path.abspath(sys.argv[1]); sys.path[:0] = [os.path.join(root, "src"), root]
import torch
import chip_smoke as C
from repro_torch.configs import get_arch
from repro_torch.kernels import runtime
from repro_torch.models import lm_zoo as Z
runtime.build()
dev = torch.device("cuda")
tag = sys.argv[2]
cfg = get_arch(C.MESH_ARCH)
depth, B, S = C.MESH_TRAIN
cut = C.train_cut(cfg, depth, "adafactor")
opt = Z.make_optimizer(cut)
box = {"state": Z.init_train_state(cut, torch.Generator(device=dev).manual_seed(5), opt, device=dev)}
batch = C.seeded_tokens(torch, cut, B, S, 5, dev)
step = Z.make_train_step(cut, opt)
G = 1 << 30

def segs():
    out = []
    for s in torch.cuda.memory_snapshot():
        free = [b["size"] for b in s["blocks"] if b["state"] == "inactive"]
        if sum(free) > (256 << 20):
            out.append((round(s["total_size"] / G, 2), round(s["allocated_size"] / G, 2), round(max(free) / G, 2)))
    return sorted(out, key=lambda t: -(t[0] - t[1]))[:12]

def one(what, i, box):
    torch.cuda.synchronize(); torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        box["state"], m = step(box.pop("state"), batch)
        torch.cuda.synchronize()
        ok = f"loss {float(m['loss']):.4f}"
    except torch.OutOfMemoryError as e:
        ok = "OOM " + str(e).split(".")[0]
    st = torch.cuda.memory_stats()
    print(json.dumps({"tree": tag, "conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"), "what": what, "step": i,
        "ms": round((time.perf_counter() - t0) * 1e3, 1), "ok": ok,
        "alloc_peak_GB": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "reserved_peak_GB": round(torch.cuda.max_memory_reserved() / 1e9, 3),
        "reserved_now_GB": round(torch.cuda.memory_reserved() / 1e9, 3),
        "alloc_retries": st.get("num_alloc_retries"), "ooms": st.get("num_ooms"),
        "segs_with_free(total,alloc,maxfree GiB)": segs()}), flush=True)
    return ok.startswith("loss")

flat = dict(box)          # as mesh_train_steps: the old state kept
one("off the mesh", 0, flat)
del flat
with C.mesh_ctx(dev):
    for i in range(3):
        if not one("mesh", i, box):
            break
