"""BENCHMARK.json against the contract, and a cell, configuration, traffic
mix and metric added as files and entries only."""

import json
import math
import os
import re

import pytest

import tiny
from benchmark.spec import HERE, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    spec = Spec()
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in d["command"])
    assert 1 <= d["run_seconds"] <= 51
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in d["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    for w in cells.values():
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "workloads",
                                           f"{w['traffic']}.json"))
        assert spec.limits(w["name"]), w["name"]
        reported = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer(w["name"])
    for c in d["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert spec.config(c["name"])["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in cells.values())
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in spec.end_to_end(cell)}
    assert len(json.dumps(d)) < 64 * 1024


def test_a_cell_config_mix_and_metric_added_as_files_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    # A new configuration: the tiny one with the GraphSage aggregator.
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-sage"
    cfg["model"]["aggregator"] = "graphsage"
    with open(os.path.join(bench, "configs", "tiny-sage.json"), "w") as f:
        json.dump(cfg, f)
    # A new traffic mix and a new metric reader, as files.
    with open(os.path.join(bench, "workloads", "train-epochs-b.json"),
              "w") as f:
        json.dump({"kind": "train", "describes": "a new mix"}, f)
    with open(os.path.join(bench, "metrics", "train.epochs_seen.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run['window']['epochs'])\n")
    with open(os.path.join(bench, "limits", "tiny-train.json")) as f:
        limits = f.read()
    with open(os.path.join(bench, "limits", "tiny-sage-train.json"),
              "w") as f:
        f.write(limits)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-sage", "source": "tiny",
                            "file": "benchmark/configs/tiny-sage.json",
                            "reduced": [], "why": "a new configuration"})
    spec["workloads"].append({"name": "tiny-sage-train", "config": "tiny-sage",
                              "traffic": "train-epochs-b", "chips": 1,
                              "why": "a new cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "epoch_s":
            m["workloads"].append("tiny-sage-train")
    spec["per_layer"].append({"name": "train.epochs_seen", "unit": "epochs",
                              "better": "higher", "source": "host_clock",
                              "layer": "train", "moves": "epoch_s",
                              "workloads": ["tiny-sage-train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    line = tiny.drive(root, "tiny-sage-train", trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["train.epochs_seen"]["value"] >= 1
    assert "train.cf_step_ms" not in line["metrics"]
    line = tiny.drive(root, "tiny-sage-train")
    assert set(line["metrics"]) == {"epoch_s", "setup_s"}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_tiny_run_is_correct_and_prints_its_checks_last(tmp_path, cell):
    line = tiny.drive(tiny.make_root(tmp_path), cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    for c in line["checks"].values():
        assert math.isfinite(c["value"])
        assert c["limit"] is None or c["value"] <= c["limit"]
