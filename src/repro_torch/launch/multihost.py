"""Multi-process launch of distributed continuous training (counterpart
of ``repro.launch.multihost``; GNNFlow §4.4/§5 as a system, not a
simulation).

Topology — one OS process per machine, G trainer ranks in each:

    parent (this module's CLI, a test, or chip_smoke.py)
      ├─ builds the CUDA kernels once (runtime.build) for the card
      ├─ picks a coordinator port + one RPC port per machine
      ├─ spawns P workers: python -m repro_torch.launch.multihost
      │  with REPRO_MH_ROLE=worker and the run in REPRO_MH_RUN_CFG
      │
      │   worker p                                  worker q
      │   ┌──────────────────────────┐   hops  ┌──────────────────────┐
      │   │ partition p  (graph)     │◄───────►│ partition q (graph)  │
      │   │ rank samplers 0..G-1     │  state  │ rank samplers 0..G-1 │
      │   │ RpcSamplingServer :port_p│   RPC   │ RpcSamplingServer    │
      │   │ trainer ranks 0..G-1 ────┼─all_red─┼─── trainer ranks     │
      │   └──────────────────────────┘  gloo   └──────────────────────┘
      │     torch.distributed (TCPStore barriers + gloo collectives)
      └─ collects one MH_RESULT json line per worker

Each worker hosts ONE graph partition, its G rank samplers and (with
``state="sharded"``) its state shard behind an ``RpcSamplingServer``
(``repro_torch.dist.transport``); k-hop requests and state rows whose
owner is remote cross process boundaries on the static rank-matched
schedule.  The worker's G ranks run in turn on its device (``cuda:{p
% device_count}``, or the CPU when asked), through the same kernels as
the in-process trainer; the shard count, the loss and the gradients
are summed over a gloo process group, staged through host memory
(several workers share one card, where NCCL refuses two ranks).
Every worker reads the same deterministic event stream and stages only
its own ranks' shards of each global batch, so the run is numerically
the in-process ``DistributedContinuousTrainer`` with the transport
swapped.

    PYTHONPATH=src python -m repro_torch.launch.multihost --device cpu \\
        --processes 2 --local-devices 2 --state sharded --model tgn

runs a small fleet on the CPU; without ``--device cpu`` every worker
runs on the card (and fails if there is none).  ``--trace FILE`` merges
the workers' span traces into one fleet timeline (``python -m
repro_torch.obs.report FILE`` summarizes it).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import get_logger, trace

_ENV = {
    "role": "REPRO_MH_ROLE",
    "pid": "REPRO_MH_PROCESS_ID",
    "nprocs": "REPRO_MH_NUM_PROCESSES",
    "coord": "REPRO_MH_COORDINATOR",
    "rpc_ports": "REPRO_MH_RPC_PORTS",
    "local_devices": "REPRO_MH_LOCAL_DEVICES",
    "device": "REPRO_MH_DEVICE",
    "run_cfg": "REPRO_MH_RUN_CFG",
    "trace_dir": "REPRO_MH_TRACE_DIR",
}
RESULT_TAG = "MH_RESULT "
WORKER_CMD = (sys.executable, "-m", "repro_torch.launch.multihost")
_SRC = str(Path(__file__).resolve().parents[2])   # the package's root
_INIT_TIMEOUT_S = 600.0   # for the whole fleet to join the process group

log = get_logger("launch.multihost")


@dataclasses.dataclass
class MultihostSpec:
    """One worker's view of the fleet, carried in the environment."""
    process_id: int
    n_processes: int
    coordinator: str               # "127.0.0.1:<port>"
    rpc_ports: Tuple[int, ...]     # sampling-server port per machine
    local_devices: int             # G trainer ranks in this process
    device: str = "cuda"           # "cuda" (the card) or "cpu"

    @classmethod
    def from_env(cls, env=os.environ) -> "MultihostSpec":
        return cls(
            process_id=int(env[_ENV["pid"]]),
            n_processes=int(env[_ENV["nprocs"]]),
            coordinator=env[_ENV["coord"]],
            rpc_ports=tuple(int(p) for p in
                            env[_ENV["rpc_ports"]].split(",")),
            local_devices=int(env[_ENV["local_devices"]]),
            device=env.get(_ENV["device"], "cuda"))

    def torch_device(self):
        """``cuda:{p % device_count}`` for the card (raises without
        one), else the CPU."""
        import torch
        from repro_torch.device import resolve
        if self.device == "cpu":
            return torch.device("cpu")
        resolve("cuda")
        return torch.device(
            f"cuda:{self.process_id % torch.cuda.device_count()}")


def free_ports(n: int) -> List[int]:
    """Reserve n distinct free TCP ports (bind-and-release)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def worker_env(process_id: int, n_processes: int, n_local_devices: int,
               coordinator: str, rpc_ports: Sequence[int], *,
               device: str = "cuda") -> Dict[str, str]:
    """Child environment for one worker: the fleet coordinates, the
    device kind, the package on ``PYTHONPATH``, and (unless set) an
    even share of the host's cores for each worker's CPU threads."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    if _SRC not in path.split(os.pathsep):
        env["PYTHONPATH"] = os.pathsep.join(p for p in (_SRC, path) if p)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // n_processes)))
    env[_ENV["role"]] = "worker"
    env[_ENV["pid"]] = str(process_id)
    env[_ENV["nprocs"]] = str(n_processes)
    env[_ENV["coord"]] = coordinator
    env[_ENV["rpc_ports"]] = ",".join(str(p) for p in rpc_ports)
    env[_ENV["local_devices"]] = str(n_local_devices)
    env[_ENV["device"]] = device
    return env


def launch(n_processes: int, n_local_devices: int, *,
           run_cfg: Optional[Dict[str, Any]] = None,
           device: str = "cuda",
           extra_env: Optional[Dict[str, str]] = None,
           timeout_s: float = 900.0,
           worker_cmd: Sequence[str] = WORKER_CMD
           ) -> List[Tuple[str, str]]:
    """Spawn the P-process fleet and wait for it.

    ``run_cfg`` (the workload, see :func:`worker_main`) travels in
    ``REPRO_MH_RUN_CFG``; ``worker_cmd`` is the workers' command (this
    module's, or ``launch.mesh_fleet``'s).  For the card the kernels are
    built here first, so the P workers do not each run ``nvcc``.  Returns
    [(stdout, stderr)] per worker on success; on any worker failure or
    timeout the whole fleet is killed and a RuntimeError carries every
    worker's output tail (a peer stuck at a barrier is a symptom — the
    root cause is in the crashed worker's stderr).
    """
    if device != "cpu":
        from repro_torch.kernels import runtime
        runtime.build()
    ports = free_ports(1 + n_processes)
    coordinator = f"127.0.0.1:{ports[0]}"
    rpc_ports = ports[1:]
    procs: List[subprocess.Popen] = []
    for pid in range(n_processes):
        env = worker_env(pid, n_processes, n_local_devices, coordinator,
                         rpc_ports, device=device)
        if run_cfg is not None:
            env[_ENV["run_cfg"]] = json.dumps(run_cfg)
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            list(worker_cmd), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    # drain every worker's pipes CONCURRENTLY: a worker that fills its
    # pipe buffer while a sibling is being waited on would block on
    # write, stall the fleet's collectives, and turn one loud traceback
    # into an opaque all-worker timeout
    bufs: List[Dict[str, str]] = [{} for _ in procs]

    def _drain(i: int) -> None:
        try:
            out, err = procs[i].communicate()   # also reaps the child
        except Exception as e:
            out, err = "", f"<pipe drain failed: {e}>"
        bufs[i]["out"], bufs[i]["err"] = out, err

    threads = [threading.Thread(target=_drain, args=(i,), daemon=True)
               for i in range(n_processes)]
    for t in threads:
        t.start()
    # fail fast: kill the fleet on the first abnormal exit, so the real
    # traceback surfaces in seconds instead of after every sibling's
    # barrier timeout
    deadline = time.monotonic() + timeout_s
    abnormal: Optional[int] = None
    while time.monotonic() < deadline:
        if all(not t.is_alive() for t in threads):
            break
        bad = [i for i, p in enumerate(procs)
               if p.poll() is not None and p.returncode != 0]
        if bad:
            abnormal = bad[0]
            break
        time.sleep(0.2)
    timed_out = [] if abnormal is not None else \
        [i for i, t in enumerate(threads) if t.is_alive()]
    if abnormal is not None or timed_out:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for t in threads:
        t.join(30.0)
    outs: List[Tuple[str, str]] = []
    failed: Optional[str] = None
    if abnormal is not None:
        failed = (f"worker {abnormal} exited "
                  f"{procs[abnormal].returncode}\n--- stderr tail ---\n"
                  f"{bufs[abnormal].get('err', '')[-3000:]}")
    for pid, p in enumerate(procs):
        out = bufs[pid].get("out", "")
        err = bufs[pid].get("err", "")
        if pid in timed_out:
            err += f"\n<worker {pid} timed out after {timeout_s}s>"
            failed = failed or f"worker {pid} timed out"
        elif p.returncode != 0 and failed is None:
            failed = (f"worker {pid} exited {p.returncode}\n"
                      f"--- stderr tail ---\n{err[-3000:]}")
        outs.append((out, err))
    for p in procs:                   # no process outlives the launch
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed:
        tails = "\n".join(
            f"=== worker {i}: stdout ===\n{o[-2000:]}\n"
            f"=== worker {i}: stderr ===\n{e[-2000:]}"
            for i, (o, e) in enumerate(outs))
        raise RuntimeError(f"multihost launch failed: {failed}\n{tails}")
    return outs


def parse_results(outs: Sequence[Tuple[str, str]]) -> List[Dict]:
    """Pull each worker's MH_RESULT json line out of its stdout."""
    results = []
    for i, (out, err) in enumerate(outs):
        lines = [l for l in out.splitlines()
                 if l.startswith(RESULT_TAG)]
        if not lines:
            raise RuntimeError(
                f"worker {i} emitted no {RESULT_TAG!r} line:\n"
                f"{out[-2000:]}\n{err[-2000:]}")
        results.append(json.loads(lines[-1][len(RESULT_TAG):]))
    return results


def collect_fleet_trace(results: Sequence[Dict],
                        out_path: str) -> Optional[str]:
    """Merge the per-worker Chrome traces named in the MH_RESULT lines
    into one fleet timeline at ``out_path``.  Each worker exported with
    its clock-sync barrier exit as t=0, so after the merge re-pids the
    events the lanes already share one offset-corrected clock.  Returns
    ``out_path``, or None when no worker produced a trace (tracing
    disabled)."""
    parts = [(r["trace"]["file"], int(r["process_id"]))
             for r in results if r.get("trace", {}).get("file")]
    if not parts:
        return None
    missing = [p for p, _ in parts if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"worker trace files missing: {missing}")
    trace.merge_chrome_files(parts, path=out_path)
    return out_path


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def init_worker_from_env() -> MultihostSpec:
    """Join this worker to the fleet's gloo process group (its TCPStore
    carries the transport's barriers)."""
    import torch.distributed as tdist
    spec = MultihostSpec.from_env()
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{spec.coordinator}",
        rank=spec.process_id, world_size=spec.n_processes,
        timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))
    return spec


def make_transport(spec: MultihostSpec):
    from repro_torch.dist.transport import RpcTransport
    return RpcTransport(spec.process_id, spec.n_processes,
                        spec.rpc_ports)


def drive_rounds(trainer, stream, *, warm: int, round_size: int,
                 rounds: int, epochs: int = 2,
                 replay_ratio: float = 0.0,
                 replay_round: int = -1,
                 walls: Optional[List[float]] = None) -> List[Any]:
    """The round schedule both the workers AND the in-process reference
    run — one shared driver, so 'same schedule' is by construction.
    ``walls``, when given, receives each round's wall seconds."""
    trainer.ingest(stream.slice(0, warm))
    out = []
    for i in range(rounds):
        sl = stream.slice(warm + i * round_size,
                          warm + (i + 1) * round_size)
        t0 = time.perf_counter()
        out.append(trainer.train_round(
            sl, epochs=epochs,
            replay_ratio=replay_ratio if i == replay_round else 0.0))
        if walls is not None:
            walls.append(time.perf_counter() - t0)
    return out


def build_run(run_cfg: Dict[str, Any], n_machines: int, n_gpus: int):
    """(model config, stream, DistConfig, trainer kwargs) of a run
    config — the one reading of it both sides share."""
    from repro_torch.configs.tgn_gdelt import GNN_MODELS, DistConfig
    from repro_torch.data.events import synth_ctdg
    cfg = GNN_MODELS[run_cfg["model"]](**run_cfg.get("model_kw", {}))
    stream = synth_ctdg(**run_cfg["stream"])
    dist = DistConfig(n_machines=n_machines, n_gpus=n_gpus,
                      **run_cfg.get("dist", {}))
    return cfg, stream, dist, dict(run_cfg.get("trainer", {}))


def load_init_params(run_cfg: Dict[str, Any], trainer) -> None:
    """Start ``trainer`` from the parameter tree saved at
    ``run_cfg["init_params"]`` (``torch.save`` of a tree of tensors,
    e.g. another framework's initialisation converted), when given."""
    path = run_cfg.get("init_params")
    if not path:
        return
    import torch
    trainer.params = torch.load(path, map_location=trainer.device,
                                weights_only=True)
    trainer.opt_state = trainer.optimizer.init(trainer.params)


def run_rounds(run_cfg: Dict[str, Any], trainer, stream,
               walls: Optional[List[float]] = None) -> List[Any]:
    """:func:`drive_rounds` with the schedule of ``run_cfg``."""
    return drive_rounds(trainer, stream, warm=run_cfg["warm"],
                        round_size=run_cfg["round_size"],
                        rounds=run_cfg["rounds"],
                        epochs=run_cfg.get("epochs", 2),
                        replay_ratio=run_cfg.get("replay_ratio", 0.0),
                        replay_round=run_cfg.get("replay_round", -1),
                        walls=walls)


def worker_main(run_cfg: Dict[str, Any],
                spec: Optional[MultihostSpec] = None) -> Dict[str, Any]:
    """Run the configured workload as one machine of the fleet and
    print the MH_RESULT line the parent collects: the round metrics,
    the wire and state traffic, the kernels' launch counts and the
    device's peak memory."""
    import torch
    import torch.distributed as tdist
    from repro_torch.dist.continuous import DistributedContinuousTrainer
    from repro_torch.kernels import runtime

    spec = spec if spec is not None else init_worker_from_env()
    device = spec.torch_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    transport = make_transport(spec)
    cfg, stream, dist, kw = build_run(run_cfg, spec.n_processes,
                                      spec.local_devices)
    runtime.reset_launch_counts()
    tr = DistributedContinuousTrainer(cfg, stream, dist,
                                      transport=transport, device=device,
                                      **kw)
    load_init_params(run_cfg, tr)
    walls: List[float] = []
    rounds = [dataclasses.asdict(m)
              for m in run_rounds(run_cfg, tr, stream, walls)]
    metrics = {**tr.metrics.snapshot(), **transport.metrics.snapshot()}
    result = {
        "process_id": spec.process_id,
        "n_processes": spec.n_processes,
        "n_local_devices": spec.local_devices,
        "device": str(device),
        "rounds": rounds,
        "round_walls": walls,
        "rpc": transport.stats(),
        "state": tr.state.stats(),
        "metrics": metrics,
        "launches": runtime.launch_counts(),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    if trace.enabled():
        # every worker reaches this barrier at the same program point
        # (REPRO_TRACE comes from the parent's env, so enabled() agrees
        # fleet-wide); its exit is each worker's t=0 in the merge
        transport.barrier("clock-sync")
        sync = trace.now_us()
        trace_dir = os.environ.get(_ENV["trace_dir"], ".")
        trace_path = os.path.join(
            trace_dir, f"mh_trace_worker{spec.process_id}.json")
        trace.export_chrome(
            trace_path, pid=spec.process_id,
            process_name=f"worker{spec.process_id}",
            clock_sync_us=sync, metadata={"metrics": metrics})
        result["trace"] = {"file": trace_path}
    print(RESULT_TAG + json.dumps(result), flush=True)
    # drain peers' last remote fetches before tearing the server down
    transport.barrier("shutdown")
    transport.close()
    tdist.destroy_process_group()
    return result


# ---------------------------------------------------------------------------
# CLI: `python -m repro_torch.launch.multihost --processes 2 ...`
# ---------------------------------------------------------------------------


def _default_run_cfg(args) -> Dict[str, Any]:
    warm, rnd = args.warm, args.round_size
    return {
        "model": args.model,
        "model_kw": dict(d_node=16, d_edge=12, d_time=10, d_hidden=32,
                         batch_size=args.batch_size,
                         **({"fanouts": (8, 4), "sampling": "recent"}
                            if args.model != "tgn" else
                            {"fanouts": (8,), "d_memory": 16})),
        "stream": dict(n_nodes=2_000,
                       n_events=warm + args.rounds * rnd,
                       t_span=60_000, d_node=16, d_edge=12,
                       alpha=2.2, seed=7),
        "dist": {"collective": args.collective},
        "trainer": dict(threshold=32, cache_ratio=0.1, lr=1e-3,
                        seed=0, overlap=True, state=args.state,
                        memory_staleness=args.memory_staleness),
        "warm": warm, "round_size": rnd, "rounds": args.rounds,
        "epochs": args.epochs,
        "replay_ratio": 0.2, "replay_round": args.rounds - 1,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    if os.environ.get(_ENV["role"]) == "worker":
        worker_main(json.loads(os.environ[_ENV["run_cfg"]]))
        return 0

    ap = argparse.ArgumentParser(
        description="spawn a P-process distributed continuous-training "
                    "run on this host (one process per machine, real "
                    "RPC and collectives)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="trainer ranks per process (run in turn on its "
                         "device)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default; worker p takes cuda:{p %% "
                         "device_count}) or the CPU")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--warm", type=int, default=2_048)
    ap.add_argument("--round-size", type=int, default=1_024)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--model", default="tgat",
                    choices=("tgat", "tgn", "graphsage", "gat"))
    ap.add_argument("--collective", default="bucketed",
                    choices=("bucketed", "quantized", "topk"))
    ap.add_argument("--state", default="replicated",
                    choices=("replicated", "sharded"),
                    help="feature/TGN-memory state service: replicated "
                         "per process, or owner-sharded over the "
                         "transport's state RPCs")
    ap.add_argument("--memory-staleness", type=int, default=0,
                    help="sharded TGN memory only: serve remote memory "
                         "reads from the prefetched copy up to k "
                         "commits stale (0 = fenced, exact; k > 0 "
                         "drops the mem-read/commit barriers for a "
                         "bounded loss deviation)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--trace", default=None, metavar="MH_TRACE.json",
                    help="enable span tracing in every worker and merge "
                         "the per-worker Chrome traces into one "
                         "Perfetto-loadable fleet timeline at this path")
    args = ap.parse_args(argv)

    extra_env = {}
    if args.trace:
        trace_dir = os.path.dirname(os.path.abspath(args.trace)) or "."
        os.makedirs(trace_dir, exist_ok=True)
        extra_env["REPRO_TRACE"] = "1"
        extra_env[_ENV["trace_dir"]] = trace_dir
    outs = launch(args.processes, args.local_devices,
                  run_cfg=_default_run_cfg(args), device=args.device,
                  extra_env=extra_env, timeout_s=args.timeout)
    results = parse_results(outs)
    for r in results:
        last = r["rounds"][-1]
        log.info(
            f"worker {r['process_id']} ({r['device']}): "
            f"{len(r['rounds'])} rounds, last loss "
            f"{last['loss']:.6f}, ap {last['ap']:.4f}, rpc "
            f"{r['rpc']['calls']} calls / "
            f"{r['rpc']['bytes_out'] + r['rpc']['bytes_in']} B / "
            f"{r['rpc']['wait_s']:.2f}s wait, state "
            f"[{r['state']['mode']}] {r['state']['calls']} calls / "
            f"{r['state']['resident_bytes']} B resident")
    # replicated training: every process must report the same losses
    l0 = [rd["loss"] for rd in results[0]["rounds"]]
    for r in results[1:]:
        li = [rd["loss"] for rd in r["rounds"]]
        if len(li) != len(l0) or not all(
                abs(a - b) <= 1e-6 for a, b in zip(l0, li)):
            log.error("workers disagree", worker0=l0,
                      **{f"worker{r['process_id']}": li})
            return 1
    if args.trace:
        merged = collect_fleet_trace(results, args.trace)
        log.info(f"fleet trace merged: {merged}")
    log.info(f"OK: {args.processes} processes agree on "
             f"{len(l0)} round losses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
