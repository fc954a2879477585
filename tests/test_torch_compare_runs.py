"""tools/compare_runs.py on the committed JAX runs, on a synthetic pair
that must not match, and on a log with a ``--resume`` restart in it."""

import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "compare_runs", os.path.join(REPO, "tools", "compare_runs.py"))
compare_runs = importlib.util.module_from_spec(_spec)
sys.modules["compare_runs"] = compare_runs   # its dataclass looks it up
_spec.loader.exec_module(compare_runs)

MID = os.path.join(REPO, "runs", "mid-plateau.jsonl")
MID_R4S = os.path.join(REPO, "runs", "mid-plateau-r4s.jsonl")


def test_committed_mid_plateau_runs_match(capsys):
    a, b = compare_runs.read_run(MID), compare_runs.read_run(MID_R4S)
    assert round(a.best[0], 4) == 0.4905 and round(b.best[0], 4) == 0.4892
    assert (a.stop, b.stop) == (210, 175)
    assert (a.early_stop, b.early_stop) == (210, 175)
    v = compare_runs.verdict([a], [b], "early-stop")
    assert v["verdict"] == "match" and v["shape_ok"] == [True]
    assert compare_runs.main(["--name", "mid-plateau", "--port", MID,
                              "--jax", MID_R4S, "--shape",
                              "early-stop"]) == 0
    out = capsys.readouterr().out
    assert "0.4905 (160)" in out and "0.4892 (125)" in out
    assert "210 (early)" in out and "175 (early)" in out
    assert "verdict: match" in out
    # Every eval epoch the two share: 5, 10, ..., 175.
    assert sum(ln.startswith("| 1") or ln.startswith("| 5 ")
               for ln in out.splitlines()) >= 2
    assert "| 175 | " in out and "| 180 | " not in out


def _log(path, events):
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return str(path)


def _run(path, recalls, secs=1.0, early=None):
    """A log with an eval every 5 epochs at the given recalls."""
    events = [{"event": "start"}]
    for i, r in enumerate(recalls):
        for e in range(5 * i + 1, 5 * i + 6):
            events.append({"event": "epoch", "epoch": e, "cf_loss": 0.5,
                           "kg_loss": 0.6, "secs": secs})
        events.append({"event": "eval", "epoch": 5 * i + 5, "recall": r,
                       "ndcg": r / 2})
    if early:
        events.append({"event": "early_stop", "epoch": early, "best": 0})
    events.append({"event": "done", "best_recall": max(recalls)})
    return _log(path, events)


def test_a_pair_003_apart_is_a_mismatch(tmp_path):
    port = compare_runs.read_run(_run(tmp_path / "p.jsonl", [0.25, 0.30]))
    jax = compare_runs.read_run(_run(tmp_path / "j.jsonl", [0.24, 0.27]))
    v = compare_runs.verdict([port], [jax])
    assert v["verdict"] == "mismatch"
    assert v["gap"] == pytest.approx(0.03) and v["tol"] == pytest.approx(
        0.0135)
    # Inside max(0.01, 5%) it matches.
    near = compare_runs.read_run(_run(tmp_path / "n.jsonl", [0.25, 0.28]))
    assert compare_runs.verdict([near], [jax])["verdict"] == "match"


def test_the_port_mean_against_the_jax_range_and_the_shapes(tmp_path):
    ports = [compare_runs.read_run(_run(tmp_path / f"p{i}.jsonl", [r],
                                        early=5))
             for i, r in enumerate((0.48, 0.50, 0.49))]
    jax = [compare_runs.read_run(MID), compare_runs.read_run(MID_R4S)]
    v = compare_runs.verdict(ports, jax, "early-stop")
    assert v["port"] == pytest.approx(0.49) and v["gap"] == 0.0
    assert v["port_spread"] == (0.48, 0.50) and v["verdict"] == "match"
    no_stop = compare_runs.read_run(_run(tmp_path / "ns.jsonl", [0.49]))
    assert compare_runs.verdict([no_stop], jax, "early-stop")[
        "verdict"] == "mismatch"
    peak = compare_runs.read_run(_run(tmp_path / "pk.jsonl",
                                      [0.31, 0.30, 0.29, 0.28]))
    late = compare_runs.read_run(_run(tmp_path / "lt.jsonl",
                                      [0.28, 0.29, 0.31, 0.30]))
    rising = compare_runs.read_run(_run(tmp_path / "rs.jsonl",
                                        [0.29, 0.31]))
    assert compare_runs.shape_ok(peak, "peak-then-decline")
    assert not compare_runs.shape_ok(late, "peak-then-decline")
    assert not compare_runs.shape_ok(rising, "peak-then-decline")


def test_a_resumed_log_is_read_as_the_run_it_became(tmp_path):
    """A run cut after epoch 12 and resumed from its epoch-10 checkpoint:
    epochs 11-12 (trained again) and the second ``start`` are read once."""
    events = [{"event": "start"}]
    for e in range(1, 13):
        events.append({"event": "epoch", "epoch": e, "cf_loss": 1.0 / e,
                       "kg_loss": 0.5, "secs": 2.0})
        if e % 5 == 0:
            events.append({"event": "eval", "epoch": e, "recall": 0.1 * e,
                           "ndcg": 0.0})
    events += [{"event": "resume", "epoch": 10, "best": 1.0,
                "bad_evals": 0, "source": "x"}, {"event": "start"}]
    for e in range(11, 21):
        events.append({"event": "epoch", "epoch": e, "cf_loss": 0.01,
                       "kg_loss": 0.5, "secs": 4.0})
        if e % 5 == 0:
            events.append({"event": "eval", "epoch": e, "recall": 1.1,
                           "ndcg": 0.0})
    events.append({"event": "done", "best_recall": 1.1})
    run = compare_runs.read_run(_log(tmp_path / "r.jsonl", events))
    assert sorted(run.epochs) == list(range(1, 21))
    assert run.epochs[11]["cf_loss"] == 0.01 and run.resumes == 1
    assert sorted(run.evals) == [5, 10, 15, 20]
    assert run.best == (1.1, 15) and run.stop == 20
    assert run.median_secs == 3.0
    out = compare_runs.report("r", [run], [run])
    assert "| 1 |" in out.splitlines()[4]  # one resume in the table
