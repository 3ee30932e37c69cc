"""BENCHMARK.json against the rules of its format, and every name it gives resolved
to its file under perfbench/."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench.bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_resolves(cell):
    b = spec.load_benchmark()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    cfg_entry = {c["name"]: c for c in b["configs"]}[w["config"]]
    assert spec.config_path(w["config"]).is_file()
    assert cfg_entry["file"] == f"perfbench/configs/{w['config']}.json"
    raw = json.loads(spec.config_path(w["config"]).read_text())
    assert sorted(raw["reduced"]) == sorted(cfg_entry["reduced"])
    assert spec.traffic_path(w["traffic"]).is_file()
    c = spec.cell(cell, b)
    for k in c.config["reduced"]:
        assert any(k in share for share in raw["run"].values())
    assert any(m["name"] != "setup_s" for m in c.end_to_end)
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert (spec.HERE / "limits" / f"{cell}.json").is_file()


def test_a_cell_mix_and_metric_are_added_as_files(tmp_path, monkeypatch):
    """A new mix, metric and cell are new files and new entries: nothing
    that exists is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load_benchmark()
    t = json.loads(spec.traffic_path("train-4k").read_text())
    t["seq_len"] = 8192
    (root / "perfbench/traffic/train-8k.json").write_text(json.dumps(t))
    (root / "perfbench/metrics/steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx['steps']\n")
    b["workloads"].append({"name": "nemotron-4-340b.train-8k",
                           "config": "nemotron-4-340b", "traffic": "train-8k",
                           "chips": 1, "why": "longer sequences"})
    b["end_to_end"][0]["workloads"].append("nemotron-4-340b.train-8k")
    b["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "step", "moves": "train_tokens_per_s",
                           "workloads": ["nemotron-4-340b.train-8k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "HERE", root / "perfbench")
    monkeypatch.setattr(spec, "BENCHMARK", root / "BENCHMARK.json")
    c = spec.cell("nemotron-4-340b.train-8k")
    assert c.traffic["seq_len"] == 8192
    assert [m["name"] for m in c.per_layer] == ["steps_seen.train"]
    assert spec.metric_reader("steps_seen.train")({"steps": 3}) == 3
