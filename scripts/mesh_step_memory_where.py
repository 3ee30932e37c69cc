"""Which allocations are live at the peak of chip_smoke.py's logical
(1, 4) mesh train step (Qwen3-MoE's full-width layer, Adafactor, B 2 x
8,192): the second step's own allocations (the allocator's history),
grouped by their three innermost frames in the port, with the live bytes
before the optimizer's update and the peaks around it.  On the card:

    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True \
        python3 scripts/mesh_step_memory_where.py ROOT TAG"""
import collections, json, os, sys
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
real_update = opt.update
marks = {}
def update(g, s, p):
    torch.cuda.synchronize()
    marks["before_update_alloc"] = torch.cuda.memory_allocated() / 1e9
    marks["fwd_bwd_peak"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    out = real_update(g, s, p)
    torch.cuda.synchronize()
    marks["update_peak"] = torch.cuda.max_memory_allocated() / 1e9
    return out
opt = type(opt)(init=opt.init, update=update)
box = {"state": Z.init_train_state(cut, torch.Generator(device=dev).manual_seed(5), opt, device=dev)}
batch = C.seeded_tokens(torch, cut, B, S, 5, dev)
step = Z.make_train_step(cut, opt)
with C.mesh_ctx(dev):
    for i in range(2):
        torch.cuda.synchronize(); torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if i == 1:
            torch.cuda.memory._record_memory_history(max_entries=400000, context="alloc", stacks="python")
        box["state"], m = step(box.pop("state"), batch)
        torch.cuda.synchronize()
        print(json.dumps({"tree": tag, "step": i, "start_GB": base / 1e9, **{k: round(v, 3) for k, v in marks.items()}}), flush=True)
snap = torch.cuda.memory._snapshot()
torch.cuda.memory._record_memory_history(enabled=None)
trace = snap["device_traces"][0]

def where(ev):
    fr = [f for f in ev.get("frames", []) if "repro_torch" in f["filename"]]
    return " < ".join(f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}" for f in fr[:3]) or "?"

def replay(stop=None):
    live, cur, peak, at = {}, 0, 0, 0
    for j, ev in enumerate(trace):
        a = ev["action"]
        if a == "alloc":
            live[ev["addr"]] = ev; cur += ev["size"]
        elif a == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
        if cur > peak:
            peak, at = cur, j
        if stop is not None and j == stop:
            return live
    return peak, at
peak, at = replay()
live = replay(at)
groups = collections.defaultdict(lambda: [0, 0, set()])
for ev in live.values():
    g = groups[where(ev)]; g[0] += ev["size"]; g[1] += 1; g[2].add(ev["size"])
print(f"[{tag}] the step's own allocations peak {peak / 1e9:.3f} GB at event {at} of {len(trace)} ({where(trace[at])})")
for k, (b, n, sizes) in sorted(groups.items(), key=lambda t: -t[1][0])[:22]:
    print(f"  {b / 1e9:8.3f} GB  {n:4d} blocks  sizes(MB) {sorted(round(x / 1e6) for x in sizes)[-4:]}  {k}")
