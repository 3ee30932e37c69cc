"""The command's refusals, and what a run's process imports."""
from __future__ import annotations

import shutil
import subprocess
import sys

from conftest import ROOT

CMD = [sys.executable, "perfbench/run.py", "--workload",
       "nemotron-4-340b.train-4k", "--seed", str(2 ** 31 + 17),
       "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin",
                                            "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_exits_nonzero_without_a_result():
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_only_the_benchmark_files_exit_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):

    from perfbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert run.forbidden_modules() == ["repro"]


PROBE = """
import sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src", {root!r} + "/perfbench/tests",
                {root!r} + "/perfbench"]
import conftest, run
from perfbench.bench import common, train, chat
common.limits = conftest.tiny_limits
for name, drv in (("qwen3-moe-235b-a22b.train-4k", train),
                  ("nemotron-4-340b.chat-b8", chat)):
    drv.run(conftest.tiny_cell(name), 5, 0.2, False, "cpu", time.time())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""


def test_a_run_imports_no_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    tops, found = r.stdout.strip().splitlines()[-2:]
    assert found == "[]", tops
    assert "'repro_torch'" in tops
