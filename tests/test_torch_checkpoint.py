"""Full-state checkpoints and ``--resume`` against ``kgat_tpu`` on the
CPU.

A checkpoint that ``kgat_tpu``'s trainer wrote resumes in the port with
its parameters, Adam moments, count and counters; the port's checkpoint
loads in ``kgat_tpu``'s loader, whose evaluate reproduces the port's best
recall; two straight epochs equal one epoch, a resume and one more; a
resume takes the newer of the best and last checkpoints. Tiny synthetic
runs on the plain ops (``ops_backend ref``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from kgat_tpu.models import kgat as jkgat
from kgat_tpu.train import Trainer as JTrainer
from kgat_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from kgat_tpu.utils.config import TrainConfig as JTrainConfig
from kgat_tpu_torch import train
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.optim import adam_count
from kgat_tpu_torch.utils.checkpoint import load_checkpoint
from kgat_tpu_torch.utils.config import TrainConfig

import torch_threads  # noqa: F401  (one intra-op thread)

SYN = dict(syn_users=60, syn_items=40, syn_entities=90, syn_relations=3,
           syn_interactions=800, syn_triples=400)
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
             mess_dropout=(0.1, 0.1))


def _port_cfg(log_dir, **kw):
    kw = {"epochs": 2, "eval_every": 1, **kw}
    return TrainConfig(dataset="synthetic", device="cpu", log_dir=str(log_dir),
                       seed=4, lr=1e-3, cf_batch_size=128, kg_batch_size=256,
                       model=kgat.KGATConfig(ops_backend="ref", **MODEL),
                       **SYN, **kw)


def _jax_cfg(log_dir, **kw):
    kw = {"epochs": 2, "eval_every": 1, **kw}
    return JTrainConfig(dataset="synthetic", log_dir=str(log_dir), seed=4,
                        lr=1e-3, cf_batch_size=128, kg_batch_size=256,
                        model=jkgat.KGATConfig(ops_backend="ref", **MODEL),
                        **SYN, **kw)


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_kgat_tpu_checkpoint_resumes_in_the_port(tmp_path):
    """kgat_tpu trains two epochs; the port resumes from its checkpoint:
    parameters, mu, nu (each value equal) and count, epoch, best_metric
    and bad_evals as kgat_tpu left them. JAX's key cannot become a torch
    generator state: the log says the generators were re-seeded, and the
    resumed port trains on."""
    jtr = JTrainer(_jax_cfg(tmp_path, run_name="run"))
    jtr.train()
    tr = train.Trainer(_port_cfg(tmp_path, run_name="run", resume=True,
                                 epochs=3))
    tr._resume()
    port = {k: kgat.numpy_params(tr.model, lambda p, k=k: tr.opt.state[p][k])
            for k in ("exp_avg", "exp_avg_sq")}
    st = jtr.opt_state[0]
    for got, want in ((kgat.numpy_params(tr.model), jtr.params),
                      (port["exp_avg"], st.mu), (port["exp_avg_sq"], st.nu)):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert adam_count(tr.opt) == int(st.count) > 0
    assert (tr.epoch, tr.best_metric, tr.bad_evals) == (
        jtr.epoch, jtr.best_metric, jtr.bad_evals)
    events = _events(tmp_path / "run.jsonl")
    assert [e["event"] for e in events][-2:] == ["resume", "rng_reseeded"]
    assert events[-2]["source"].endswith("run_best") or events[-2][
        "source"].endswith("run_best_last")
    cf, kg = tr.train_one_epoch()
    assert np.isfinite([cf, kg]).all()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's CLI, two epochs with an eval after each."""
    root = tmp_path_factory.mktemp("port_ckpt")
    tr = train.Trainer(_port_cfg(root, run_name="port"))
    tr.train()
    return root, tr


def test_port_checkpoint_loads_in_kgat_tpu(port_run):
    """kgat_tpu.utils.checkpoint.load_checkpoint reads the port's best
    checkpoint into its trainer's structures, the count and moments as the
    port saved them, and kgat_tpu's evaluate reproduces the recorded
    best_metric at rtol 1e-5 (as tests/test_train_e2e.py:48-67 does for
    kgat_tpu's own)."""
    root, tr = port_run
    jtr = JTrainer(_jax_cfg(root, run_name="jax"))
    params, opt_state, meta, rng = jax_load_checkpoint(
        tr.ckpt_path(), jtr.params, jtr.opt_state)
    state = load_checkpoint(tr.ckpt_path())
    assert int(opt_state[0].count) == state["count"] > 0
    for a, b in zip(_leaves(opt_state[0].mu), _leaves(state["mu"])):
        np.testing.assert_array_equal(a, b)
    assert np.asarray(jax.random.key_data(rng)).tolist() == [4, meta["epoch"]]
    jtr.params, jtr.opt_state = params, opt_state
    m = jtr.evaluate()
    np.testing.assert_allclose(m["recall"], meta["best_metric"], rtol=1e-5)
    assert meta["best_metric"] == tr.best_metric


def test_resume_continues_as_a_straight_run(tmp_path):
    """Two straight epochs equal one epoch, a --resume from its last
    checkpoint and one more: parameters and Adam's state torch.equal on
    the CPU, whose kernels add in a fixed order (the generator's state is
    in the checkpoint; the attention is recomputed from the restored
    parameters, as the straight run recomputed it after epoch 1)."""
    straight = train.Trainer(_port_cfg(tmp_path / "a"))
    straight.train()
    train.Trainer(_port_cfg(tmp_path / "b", epochs=1)).train()
    resumed = train.Trainer(_port_cfg(tmp_path / "b", resume=True))
    resumed.train()
    assert resumed.epoch == straight.epoch == 2
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(straight.opt.state[p][k],
                               resumed.opt.state[q][k]), k
    assert straight.best_metric == resumed.best_metric
    events = [e["event"] for e in _events(tmp_path / "b" / "kgat.jsonl")]
    assert events == ["start", "epoch", "eval", "done", "resume", "start",
                      "epoch", "eval", "done"]


def test_resume_prefers_newest_of_best_and_last(port_run, tmp_path):
    """The rolling last checkpoint advances every eval; --resume restores
    from whichever of best and last has the higher epoch, and from best
    alone when last is gone (tests/test_train_e2e.py:95); with neither it
    logs resume_missing and starts from epoch 0."""
    root, tr = port_run
    with open(tr.last_ckpt_path() + ".json") as f:
        last = json.load(f)
    with open(tr.ckpt_path() + ".json") as f:
        best = json.load(f)
    assert last["epoch"] == 2 and last["epoch"] >= best["epoch"]
    assert last["model"]["conv_dims"] == [16, 8]
    cfg = _port_cfg(root, run_name="port", resume=True)
    tr2 = train.Trainer(cfg)
    tr2._resume()
    assert (tr2.epoch, tr2.best_metric, tr2.bad_evals) == (
        last["epoch"], best["best_metric"], last["bad_evals"])
    # Best alone: a copy of the run without its last checkpoint.
    for ext in (".npz", ".json"):
        with open(tr.ckpt_path() + ext, "rb") as f:
            data = f.read()
        with open(os.path.join(tmp_path, "port_best" + ext), "wb") as f:
            f.write(data)
    tr3 = train.Trainer(_port_cfg(tmp_path, run_name="port", resume=True))
    tr3._resume()
    assert tr3.epoch == best["epoch"]
    tr4 = train.Trainer(_port_cfg(tmp_path / "empty", resume=True))
    tr4._resume()
    assert tr4.epoch == 0
    assert [e["event"] for e in _events(tmp_path / "empty" / "kgat.jsonl")
            ] == ["resume_missing"]


def test_partitioned_trainer_resumes(tmp_path):
    """--resume on the partitioned trainer (its parameters and Adam are
    single copies): the per-partition dropout generators' states come back
    with the rest, so a resumed epoch equals the straight run's second."""
    kw = dict(n_devices=4, halo_exchange="ring", ring_transport="dma")
    straight = train.Trainer(_port_cfg(tmp_path / "a", **kw))
    straight.train()
    train.Trainer(_port_cfg(tmp_path / "b", epochs=1, **kw)).train()
    resumed = train.Trainer(_port_cfg(tmp_path / "b", resume=True, **kw))
    resumed.train()
    assert resumed.partitioned and resumed.epoch == 2
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)
    for g, h in zip(straight.part_generators, resumed.part_generators):
        assert torch.equal(g.get_state(), h.get_state())
