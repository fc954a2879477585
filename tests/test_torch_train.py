"""The port's trainer (``python -m kgat_tpu_torch.train``) on the CPU.

Two epochs on a small dataset, as the CLI runs them with ``--device cpu``:
the JSONL carries the events and keys of ``kgat_tpu``'s trainer (run here
on the same data), the losses start near ln 2, and the best checkpoint
serves through ``kgat_tpu_torch.recommend.main`` and reads back through
``kgat_tpu``'s loader. The CLI also runs end to end in a process where any
import of jax raises, as on the GPU machine, which has no jax.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kgat_tpu.models.kgat import KGATConfig as JKGATConfig
from kgat_tpu.train import Trainer as JTrainer
from kgat_tpu.utils.checkpoint import load_params as jax_load_params
from kgat_tpu.utils.config import TrainConfig as JTrainConfig
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch import recommend as trec
from kgat_tpu_torch import train
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.parallel import dp
from kgat_tpu_torch.utils.config import TrainConfig, parse_args

import torch_threads  # one intra-op thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(seed=2, n_users=60, n_items=40, n_entities=90, n_relations_kg=3,
             n_interactions=800, n_triples=400)
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
             mess_dropout=(0.1, 0.1))
MODEL_FLAGS = ["--embed-dim", "16", "--relation-dim", "16", "--conv-dims",
               "16,8", "--mess-dropout", "0.1,0.1"]
SYN_FLAGS = ["--syn-users", "60", "--syn-items", "40", "--syn-entities", "90",
             "--syn-relations", "3", "--syn-interactions", "800",
             "--syn-triples", "400"]


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI and kgat_tpu's trainer, two epochs each on one saved
    dataset, evaluated after each."""
    root = tmp_path_factory.mktemp("train")
    data_root = str(root / "data")
    ds = dataclasses.replace(tdata.synthetic_dataset(**SMALL),
                             name="tinytrain")
    tdata.save_dataset(ds, data_root)
    common = dict(dataset="tinytrain", data_root=data_root, epochs=2,
                  eval_every=1, cf_batch_size=128, kg_batch_size=256, seed=0,
                  log_dir=str(root / "runs"))
    train.main(["--device", "cpu", "--ops-backend", "ref", "--run-name",
                "port", *MODEL_FLAGS,
                *(a for key, v in common.items()
                  for a in (f"--{key.replace('_', '-')}", str(v)))])
    JTrainer(JTrainConfig(run_name="jax", model=JKGATConfig(**MODEL),
                          **common)).train()
    return dict(root=root, data_root=data_root, ds=ds,
                port=_events(root / "runs" / "port.jsonl"),
                jax=_events(root / "runs" / "jax.jsonl"),
                best=str(root / "runs" / "port_best"))


def test_jsonl_has_kgat_tpus_events_and_keys(runs):
    port, want = runs["port"], runs["jax"]
    assert [e["event"] for e in port] == [e["event"] for e in want] == [
        "start", "epoch", "eval", "epoch", "eval", "done"]
    for got, ref in zip(port, want):
        assert sorted(got) == sorted(ref), got["event"]
    start = port[0]
    assert (start["backend"], start["sampler"]) == ("ref", "device")
    for key in ("n_nodes", "n_edges", "n_relations", "cf_batches",
                "kg_batches"):
        assert start[key] == want[0][key], key


def test_losses_start_near_ln2_and_metrics_are_rates(runs):
    """The first epoch's mean losses lie near ln 2, the loss of an
    untrained pairwise term, as kgat_tpu's do (on identical params and
    batches the two losses agree to 1e-5: tests/test_torch_grads.py)."""
    for events in (runs["port"], runs["jax"]):
        first = events[1]
        for key in ("cf_loss", "kg_loss"):
            assert abs(first[key] - math.log(2)) < 0.1, first
    for ev in (e for e in runs["port"] if e["event"] == "eval"):
        for key in ("recall", "ndcg", "precision", "hit"):
            assert 0.0 <= ev[key] <= 1.0, ev


def test_best_checkpoint_serves_and_reads_in_kgat_tpu(runs, tmp_path):
    best = runs["best"]
    with open(best + ".json") as f:
        side = json.load(f)
    assert side["dataset"] == "tinytrain"
    assert side["model"]["conv_dims"] == [16, 8]
    out = str(tmp_path / "recs.jsonl")
    users = sorted(runs["ds"].test_user_dict)[:6]
    assert trec.main(["--ckpt", best, "--data-root", runs["data_root"],
                      "--device", "cpu", "--users",
                      ",".join(str(u) for u in users), "--k", "5",
                      "--out", out]) == 0
    lines = _events(out)
    assert [ln["user"] for ln in lines] == users
    for ln in lines:
        seen = set(runs["ds"].train_user_dict[ln["user"]].tolist())
        assert len(ln["items"]) == 5 and not seen & set(ln["items"])
        assert (np.diff(ln["scores"]) <= 0).all()
    params, meta = jax_load_params(best)
    assert meta["epoch"] >= 1 and len(params["layers"]) == 2
    assert params["w_rel"].shape[1:] == (16, 16)
    assert os.path.exists(runs["best"] + "_last.npz")


BLOCKED = """
import runpy, sys
sys.modules["jax"] = None        # any import of jax raises ImportError
sys.modules["kgat_tpu"] = None
sys.path.insert(0, {repo!r})
sys.argv = ["train"] + {argv!r}
runpy.run_module("kgat_tpu_torch.train", run_name="__main__")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kgat_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
"""


@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_cli_runs_without_jax(tmp_path, backend):
    """The whole CLI (train, evaluate, checkpoint) with jax blocked: a lazy
    import of jax or the JAX package on the card's path would raise here.
    The hopper backend takes its plain versions for CPU tensors."""
    argv = ["--device", "cpu", "--ops-backend", backend, "--dataset",
            "synthetic", "--epochs", "2", "--eval-every", "1",
            "--cf-batch-size", "256", "--kg-batch-size", "512",
            "--log-dir", str(tmp_path), "--run-name", "blocked",
            *MODEL_FLAGS, *SYN_FLAGS]
    proc = subprocess.run([sys.executable, "-I", "-c",
                           BLOCKED.format(repo=REPO, argv=argv)],
                          capture_output=True, text=True, timeout=240,
                          env=torch_threads.one_thread_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "LEAKED []"
    events = _events(tmp_path / "blocked.jsonl")
    assert [e["event"] for e in events][-1] == "done"
    assert os.path.exists(tmp_path / "blocked_best.npz")


def test_default_device_needs_cuda():
    """No CPU fallback: the default --device cuda raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--dataset", "synthetic", "--log-dir", "", *SYN_FLAGS])


@pytest.mark.parametrize("flags", [["--att-impl", "dense"]])
def test_unported_flags_are_refused(flags, capsys):
    """No flag of ``kgat_tpu``'s is refused any more: the last one the
    port refused, ``--att-impl dense``, parses into the dense-projection
    route it now has, with no error."""
    cfg = parse_args(flags)
    assert cfg.model.att_impl == "dense"
    assert capsys.readouterr().err == ""


# tools/campaigns.md's mid-plateau command line, as kgat_tpu runs it.
MID_PLATEAU = ["--dataset", "synthetic", "--syn-users", "3000", "--syn-items",
               "2000", "--syn-entities", "4000", "--syn-relations", "8",
               "--syn-interactions", "60000", "--syn-triples", "40000",
               "--ops-backend", "pallas", "--compute-dtype", "bf16", "--lr",
               "1e-3", "--epochs", "300", "--eval-every", "5", "--run-name",
               "mid-plateau"]


def test_pallas_backend_name_selects_hopper(tmp_path):
    """kgat_tpu's name for its kernel backend, ``--ops-backend pallas``,
    is accepted so that its command lines run unchanged, and selects the
    Hopper kernels; a CLI epoch with it logs the hopper backend."""
    cfg = parse_args(MID_PLATEAU)
    assert cfg.model.ops_backend == "hopper"
    assert cfg.model.compute_dtype == torch.bfloat16
    assert (cfg.lr, cfg.epochs, cfg.eval_every, cfg.syn_interactions) == (
        1e-3, 300, 5, 60000)
    train.main(["--device", "cpu", "--ops-backend", "pallas", "--dataset",
                "synthetic", "--epochs", "1", "--log-dir", str(tmp_path),
                *MODEL_FLAGS, *SYN_FLAGS])
    start = next(e for e in _events(tmp_path / "kgat.jsonl")
                 if e["event"] == "start")
    assert start["backend"] == "hopper"


PARTITIONED_MODES = ["--n-devices 4 --halo-exchange a2a",
                     "--n-devices 4 --dp-replicas 2",
                     "--n-devices 4 --dp-replicas 2 --halo-exchange a2a"]


@pytest.mark.parametrize("mode", ["--sparse-adam", "--use-pretrain",
                                  "--sampler host", "--resume",
                                  *PARTITIONED_MODES])
def test_ported_flags_reach_the_trainer(mode, tmp_path):
    """The flags that were refused until their modules were ported: each
    is accepted, and a CLI epoch on the CPU (what ``main`` runs) shows it
    took effect: the log names the sampler, the pretrain npz or the
    resume; under --sparse-adam the KG phase leaves the CF phase's
    gradients of the conv weights in place (the dense KG step zeroes
    them); the a2a exchange and the (dp, ep) mesh build their partitions
    and say in the epoch event that the CPU runs eager steps."""
    flags = mode.split()
    if mode == "--use-pretrain":
        rs = np.random.default_rng(0)
        npz = str(tmp_path / "mf.npz")
        ue, ie = (rs.normal(size=(n, 16)).astype(np.float32)
                  for n in (60, 40))
        np.savez(npz, user_embed=ue, item_embed=ie)
        flags.append(npz)
    cfg = parse_args(["--device", "cpu", "--ops-backend", "ref", "--dataset",
                      "synthetic", "--epochs", "1", "--cf-batch-size", "256",
                      "--kg-batch-size", "512", "--log-dir", str(tmp_path),
                      *MODEL_FLAGS, *SYN_FLAGS, *flags])
    tr = train.Trainer(cfg)
    if mode == "--use-pretrain":
        emb = tr.model.entity_embed.detach().numpy()
        np.testing.assert_array_equal(emb[:40], ie)
        np.testing.assert_array_equal(emb[90:150], ue)
    tr.train()
    events = _events(tmp_path / "kgat.jsonl")
    names = [e["event"] for e in events]
    assert names[-4:] == ["start", "epoch", "eval", "done"]
    start = events[names.index("start")]
    assert start["sampler"] == ("host" if mode == "--sampler host"
                                else "device")
    assert ("pretrain" in names) == (mode == "--use-pretrain")
    assert (names[0] == "resume_missing") == (mode == "--resume")
    conv = tr.model.layers[0]["w1"].grad
    assert bool(conv.any()) == (mode == "--sparse-adam")
    epoch = events[names.index("epoch")]
    if mode in PARTITIONED_MODES:
        dp_rows = 2 if "--dp-replicas" in flags else 1
        assert (tr.dp_replicas, tr.n_parts) == (dp_rows, 4 // dp_rows)
        assert tr.part.exchange == ("a2a" if "a2a" in flags
                                    else "allgather")
        assert (epoch["captured"], epoch["why"]) == (
            False, "the CPU runs eager steps")
    else:
        assert "captured" not in epoch and not tr.partitioned


def test_multi_host_is_refused(monkeypatch, capsys):
    """A multi-process launch (kgat_tpu's NUM_PROCESSES) parses; what is
    refused is a layout the processes cannot share: a process count that
    does not divide --n-devices, and processes whose slots would straddle
    two dp rows (``dp.process_layout``)."""
    monkeypatch.setenv("NUM_PROCESSES", "2")
    assert parse_args(["--n-devices", "4"]).n_devices == 4
    assert capsys.readouterr().err == ""
    with pytest.raises(ValueError, match="must divide --n-devices"):
        dp.process_layout(3, 3, 2)
    with pytest.raises(ValueError, match="straddle two rows"):
        dp.process_layout(6, 3, 3)
    assert dp.process_layout(4, 2, 2) == (0, 0, 1, 1)


@pytest.mark.parametrize("flags,want", [
    (["--n-devices", "4"], (4, "allgather", "ppermute")),
    (["--n-devices", "4", "--halo-exchange", "ring"], (4, "ring",
                                                       "ppermute")),
    (["--n-devices", "3", "--halo-exchange", "ring", "--ring-transport",
      "dma"], (3, "ring", "dma")),
    (["--n-devices", "4", "--halo-exchange", "ring", "--ring-transport",
      "fused", "--dp-replicas", "1", "--no-coalesce"], (4, "ring", "fused")),
    (["--preset", "yelp-partitioned"], (0, "allgather", "ppermute"))])
def test_partitioning_flags_are_accepted(flags, want):
    cfg = parse_args(flags)
    assert (cfg.n_devices, cfg.halo_exchange, cfg.ring_transport) == want
    assert cfg.model.ops_backend == "hopper"
    if "--preset" in flags:
        assert cfg.dataset == "yelp2018"
        assert cfg.model.conv_dims == (64, 32, 16)


def test_n_devices_zero_means_one_partition_per_gpu(tmp_path):
    """``--n-devices 0`` is one partition per visible GPU; on the CPU that
    is one, the single-device path (as JAX's 0 is every device)."""
    tr = _tiny_trainer(tmp_path, n_devices=0)
    assert (tr.n_parts, tr.partitioned) == (1, False)
    with pytest.raises(SystemExit):
        parse_args(["--n-devices", "-1"])


def test_presets_and_defaults():
    cfg = parse_args([])
    assert (cfg.device, cfg.model.ops_backend) == ("cuda", "hopper")
    assert (cfg.lr, cfg.cf_batch_size, cfg.kg_batch_size) == (1e-4, 1024,
                                                              2048)
    assert cfg.model.conv_dims == (64, 32, 16)
    assert cfg.model.mess_dropout == (0.1, 0.1, 0.1)
    smoke = parse_args(["--preset", "smoke-gcn", "--ks", "20,40"])
    assert smoke.model.ops_backend == "hopper" and smoke.ks == (20, 40)
    assert smoke.model.conv_dims == (32,)
    with pytest.raises(SystemExit):
        parse_args(["--conv-dims", "8,8", "--mess-dropout", "0.1"])


def _tiny_trainer(tmp_path, **kw):
    cfg = TrainConfig(dataset="synthetic", device="cpu", seed=1,
                      log_dir=str(tmp_path), cf_batch_size=128,
                      kg_batch_size=256,
                      model=KGATConfig(ops_backend="ref", **MODEL),
                      syn_users=60, syn_items=40, syn_entities=90,
                      syn_relations=3, syn_interactions=800,
                      syn_triples=400, **kw)
    return train.Trainer(cfg)


def test_early_stop_keeps_best_and_last(tmp_path, monkeypatch):
    """stopping_steps bad evals in a row stop the run; the best checkpoint
    is the epoch of the best recall, the last one the final eval's."""
    tr = _tiny_trainer(tmp_path, epochs=10, eval_every=1, stopping_steps=2)
    recalls = iter([0.3, 0.2, 0.1, 0.4])
    monkeypatch.setattr(tr, "train_one_epoch", lambda: (0.5, 0.5))
    monkeypatch.setattr(tr, "evaluate", lambda: {
        "recall": next(recalls), "ndcg": 0.1, "precision": 0.1, "hit": 0.1})
    tr.train()
    events = _events(tmp_path / "kgat.jsonl")
    assert [e["event"] for e in events] == [
        "start", "epoch", "eval", "epoch", "eval", "epoch", "eval",
        "early_stop", "done"]
    assert events[-1]["best_recall"] == 0.3
    for path, epoch in ((tr.ckpt_path(), 1), (tr.last_ckpt_path(), 3)):
        with open(path + ".json") as f:
            assert json.load(f)["epoch"] == epoch


def test_every_parameter_gets_a_gradient_each_step(tmp_path):
    """The CF phase leaves w_rel and rel_embed a zero gradient, the KG
    phase the layer weights; Adam steps every parameter either way, with
    one shared step count, as optax's adam over the whole tree does."""
    tr = _tiny_trainer(tmp_path, epochs=1)
    att = tr.attention()
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    loss = tr.cf_grad(att, *tr.sample_cf())
    assert loss.device.type == "cpu" and math.isfinite(float(loss))
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    assert all(g is not None for g in grads.values())
    assert not grads["w_rel"].any() and not grads["rel_embed"].any()
    assert grads["layers.0.w1"].any() and grads["entity_embed"].any()
    tr.opt.step()
    tr.kg_step(*tr.sample_kg())
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    assert not grads["layers.0.w1"].any() and grads["w_rel"].any()
    steps = {int(tr.opt.state[p]["step"]) for p in tr.model.parameters()}
    assert steps == {2}
    moved = {n for n, p in tr.model.named_parameters()
             if not torch.equal(p, before[n])}
    assert moved == set(before)
