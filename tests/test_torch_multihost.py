"""Multi-process training over ``torch.distributed`` (gloo on the CPU)
against ``kgat_tpu`` and against the port's one-process engine.

Four worker processes (``tests/torch_mp_worker.py``, which imports no
jax) form a gloo group through a ``file://`` rendezvous under
``tmp_path``, one slot of a P = 4 mesh each, and run every exchange:
all-gather, the ring under ppermute, dma and fused, a2a, and a (2, 2)
(dp, ep) mesh under ring/fused. Their results are held:

* against ``kgat_tpu``'s single-process ``make_partitioned`` and
  ``make_dp_kg_step`` on the virtual CPU mesh of ``tests/conftest.py``
  (``ops_backend="ref"``, dropout 0), with ``tests/test_torch_halo_mesh.
  py``'s tolerances: the forward rtol/atol 1e-4, the CF and KG losses rtol
  1e-5, the entity table after one Adam step atol 2e-5;
* against the port's one-process ``Partitioned`` with dropout on (slot i
  draws from a generator seeded 3 + 1 + i in both), where the same
  float32 terms are summed in another order (the partial losses and
  gradients of four processes): losses and gradients within rtol 1e-5 and
  atol 1e-6, and the attention, which each process computes for its own
  shard exactly as one process does, within 1e-6;
* the processes against one another: the summed loss, gradients and
  updated table bit-identical on every process.

Then the trainer CLI on a group of two processes, its sharded checkpoints
and ``--resume``, and each package reading the other's shards.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu.data import synthetic_dataset as j_synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.models.kgat import KGATConfig as JKGATConfig
from kgat_tpu.parallel import make_dp_kg_step
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.parallel.halo import AXIS, make_partitioned as j_make_partitioned
from kgat_tpu.utils import checkpoint as jckpt
from kgat_tpu_torch import train
from kgat_tpu_torch.graph import CKGMeta
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.models.kgat import KGATConfig
from kgat_tpu_torch.parallel import dp, halo, multihost
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.utils import checkpoint as ckpt

import torch_threads
import torch_mp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
N_PROCS = 4
P = worker.P
B = 32
LIMIT = 180          # seconds, for every subprocess
CASES = worker.CASES
IDS = [worker.label(*c, 0.0)[:-4] for c in CASES]
RESULT = re.compile(r"^RESULT case=(\S+) pid=(\d+) (.*)$", re.M)


def _env(**kw) -> dict:
    env = torch_threads.one_thread_env()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    return {**env, **kw}


def _finish(procs) -> list:
    """Each process's output, after it ended (killed past LIMIT)."""
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=LIMIT)[0])
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append(proc.communicate()[0] + "\n<killed: timeout>")
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The graph, weights and batches, written for the workers, and the
    workers started (they run while the references are computed)."""
    tmp = tmp_path_factory.mktemp("mp")
    ds = j_synthetic_dataset(seed=21, n_users=200, n_items=150,
                             n_entities=300, n_relations_kg=3,
                             n_interactions=1500, n_triples=1000)
    g, jmeta = ds.build()
    coo = host_coo(g)
    jparams = jkgat.init_params(jax.random.key(0), jmeta.n_nodes,
                                jmeta.n_relations,
                                JKGATConfig(ops_backend="ref",
                                            **worker.MODEL))
    np_params = jax.tree.map(np.asarray, jparams)
    rs = np.random.default_rng(5)
    tri = np.stack([coo["dst"], coo["etype"], coo["src"]], axis=1)
    pick = tri[rs.integers(0, len(tri), B)]
    arrays = dict(
        src=coo["src"], dst=coo["dst"], ety=coo["etype"],
        u=(np.arange(B) % jmeta.n_users).astype(np.int32),
        ip=(np.arange(B) % jmeta.n_items).astype(np.int32),
        ineg=((np.arange(B) + 3) % jmeta.n_items).astype(np.int32),
        w=np.ones(B, np.float32), h=pick[:, 0].astype(np.int32),
        r=pick[:, 1].astype(np.int32), tp=pick[:, 2].astype(np.int32),
        tn=rs.integers(0, jmeta.n_nodes, B).astype(np.int32),
        kw=np.ones(B, np.float32),
        **{k: getattr(jmeta, k) for k in worker.META},
        **ckpt._flatten(np_params, "p"))
    path = str(tmp / "setup.npz")
    np.savez(path, **arrays)
    url = f"file://{tmp}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, url, str(N_PROCS), str(pid), path,
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(), cwd=str(tmp)) for pid in range(N_PROCS)]
    return dict(tmp=tmp, jmeta=jmeta, coo=coo, jparams=jparams,
                np_params=np_params, arrays=arrays, procs=procs,
                meta=CKGMeta(**dataclasses.asdict(jmeta)))


@pytest.fixture(scope="module")
def refs(setup):
    """kgat_tpu's forward, CF step (dropout 0) and DP KG step for every
    case on the virtual CPU mesh; computed while the workers run."""
    coo, jmeta, jparams = setup["coo"], setup["jmeta"], setup["jparams"]
    a = setup["arrays"]
    opt = optax.adam(worker.LR)
    out = {}
    layouts = {}
    for parts in (P, P // 2):
        jpg, jinfo = jpart.partition_graph(coo["src"], coo["dst"],
                                           coo["etype"], jmeta.n_nodes,
                                           jmeta.n_relations, parts)
        layouts[parts] = (jpg, jinfo, jpart.build_ring_buckets(
            coo["src"], coo["dst"], jinfo), jpart.build_selective_halo(
            coo["src"], coo["dst"], jinfo))
    for (exchange, transport, rows), name in zip(CASES, IDS):
        pltpu.reset_tpu_interpret_mode_state()
        jpg, jinfo, jrb, jsh = layouts[P // rows]
        mesh = (jax.make_mesh((P,), (AXIS,), axis_types=(
            jax.sharding.AxisType.Auto,), devices=jax.devices()[:P])
            if rows == 1 else jax.make_mesh(
                (rows, P // rows), ("dp", AXIS), axis_types=(
                    jax.sharding.AxisType.Auto,) * 2,
                devices=jax.devices()[:P]))
        attention, propagate_eval, make_cf_step, _ = j_make_partitioned(
            mesh, jpg, jinfo, jmeta, JKGATConfig(
                ops_backend="ref", mess_dropout=(0.0, 0.0), **worker.MODEL),
            exchange=exchange,
            ring_buckets=jrb if exchange == "ring" else None,
            sel_halo=jsh if exchange == "a2a" else None,
            ring_transport=transport, dp_axis="dp" if rows > 1 else None)
        _, ew = attention(jpg, jparams)
        emb = np.asarray(propagate_eval(ew, jparams))
        jp = jax.tree.map(jnp.copy, jparams)
        p_j, _, loss = make_cf_step(opt)(jp, opt.init(jp), ew, a["u"],
                                         a["ip"], a["ineg"], a["w"],
                                         jax.random.key(9))
        out[name] = dict(all_embed=emb, loss=float(loss),
                         entity=np.asarray(p_j["entity_embed"]))
    jp = jax.tree.map(jnp.copy, jparams)
    mesh = jax.make_mesh((P,), (AXIS,), axis_types=(
        jax.sharding.AxisType.Auto,), devices=jax.devices()[:P])
    p_j, _, loss = make_dp_kg_step(mesh, JKGATConfig(
        ops_backend="ref", **worker.MODEL), opt, axis=AXIS)(
        jp, opt.init(jp), a["h"], a["r"], a["tp"], a["tn"])
    out["kg"] = dict(loss=float(loss), entity=np.asarray(p_j["entity_embed"]))
    return out


@pytest.fixture(scope="module")
def results(setup, refs):
    """The workers' RESULT lines and files, by case and process."""
    outs = _finish(setup["procs"])
    lines = {}
    for pid, out in enumerate(outs):
        for case, got_pid, rest in RESULT.findall(out):
            assert int(got_pid) == pid
            lines[(case, pid)] = rest
    files = {}
    for case in {c for c, _ in lines} - {"group"}:
        for pid in range(N_PROCS):
            with np.load(setup["tmp"] / f"{case}.{pid}.npz") as z:
                files[(case, pid)] = {k: z[k] for k in z.files}
    return dict(lines=lines, files=files, outs=outs, tmp=setup["tmp"])


def _one_process(setup, exchange, transport, rows, dropout):
    """The port's one-process engine on the same graph, weights and
    batch, with dropout from generators seeded SEED + 1 + i: attention,
    loss and gradients."""
    cfg = KGATConfig(ops_backend="hopper", mess_dropout=(dropout,) * 2,
                     **worker.MODEL)
    a = setup["arrays"]
    shards, info = partition_graph(a["src"], a["dst"], a["ety"],
                                   setup["meta"].n_nodes,
                                   setup["meta"].n_relations, P // rows)
    part = halo.Partitioned(
        dp.make_mesh(P // rows, "cpu", rows), shards, info, setup["meta"],
        cfg, exchange=exchange,
        ring_buckets=(build_ring_buckets(a["src"], a["dst"], info)
                      if exchange == "ring" else None),
        halos=build_selective_halo(shards, info) if exchange == "a2a"
        else None, ring_transport=transport)
    model = kgat.params_from_jax(setup["np_params"], cfg)
    atts, staged = part.attention(model)
    t = lambda k: torch.from_numpy(a[k])  # noqa: E731
    loss = part.cf_loss(model, staged, t("u").long(), t("ip").long(),
                        t("ineg").long(), weight=t("w"), generators=[
                            torch.Generator().manual_seed(worker.SEED + 1 + i)
                            for i in range(P)])
    loss.backward()
    return atts, float(loss.detach()), {
        k: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        for k, p in model.named_parameters()}


# --- one process -------------------------------------------------------------

def test_one_process_forms_no_group(monkeypatch):
    """NUM_PROCESSES <= 1 (or none) is a no-op: rank 0, no group."""
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert multihost.initialize_distributed() == 0
    assert multihost.initialize_distributed("localhost:1", 1, 0, "cpu") == 0
    assert not torch.distributed.is_initialized()
    assert multihost.world() == (0, 1)


def test_conflicting_group_specs_raise(monkeypatch):
    """A second call with another spec raises with kgat_tpu's message."""
    monkeypatch.setattr(multihost, "_initialized", ("h0:1", 2, 0))
    with pytest.raises(RuntimeError, match="conflicting group specs"):
        multihost.initialize_distributed("h0:2", 2, 0, "cpu")


def test_slot_owners_and_local_shard_ids():
    """Process i owns slots [i N / W, (i + 1) N / W); W must divide N; a
    process's slots lie in one dp row or fill whole rows."""
    assert multihost.slot_owners(8, 4) == (0, 0, 1, 1, 2, 2, 3, 3)
    assert multihost.local_shard_ids(8, rank=1, n_procs=4) == [2, 3]
    assert multihost.local_shard_ids(4) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="must divide --n-devices"):
        multihost.slot_owners(6, 4)
    assert dp.process_layout(8, 2, 2) == (0,) * 4 + (1,) * 4
    with pytest.raises(ValueError, match="straddle two rows"):
        dp.process_layout(6, 2, 2)
    assert multihost.init_method("h:1") == "tcp://h:1"
    assert multihost.init_method("file:///x") == "file:///x"
    assert multihost.backend_for("cpu") == "gloo"


class _Event:
    """A stand-in for ``torch.cuda.Event`` whose work ends after
    ``ready_after`` queries (never for None)."""

    def __init__(self, ready_after=0):
        self.ready_after, self.queries, self.records = ready_after, 0, 0

    def record(self, stream):
        self.records += 1

    def query(self):
        self.queries += 1
        return self.ready_after is not None and (
            self.queries > self.ready_after)


@pytest.mark.parametrize("world,cards,want", [(4, 4, 2), (8, 4, 2),
                                             (2, 4, 4), (1, 4, 8),
                                             (4, 16, 2), (4, 0, 8)])
def test_processes_of_one_host_share_its_cores(world, cards, want):
    """Each of the min(world, cards) processes on a host keeps its share
    of the threads it had (8 here), never fewer than one."""
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(8)
        assert multihost.share_host_cores(world, cards) == want
        assert torch.get_num_threads() == want
        torch.set_num_threads(1)
        assert multihost.share_host_cores(world, cards) == 1
    finally:
        torch.set_num_threads(before)


def test_watch_keeps_depth_events_outstanding():
    """``Watch`` records an event per piece of work, waits for the oldest
    once ``depth`` are outstanding, and ``drain`` for the last."""
    w = multihost.Watch("cpu", depth=3, timeout_s=5.0,
                        event=lambda: _Event(ready_after=2))
    for _ in range(3):
        w.mark()
    assert [e.queries for e in w.events] == [0, 0, 0]
    w.mark()          # the fourth reuses the first, once it has ended
    assert [e.queries for e in w.events] == [3, 0, 0]
    assert [e.records for e in w.events] == [2, 1, 1]
    w.drain()         # the last (the first event again) has ended
    assert w.events[0].queries == 4


def test_watch_raises_when_the_work_never_ends():
    """Work that does not end within the timeout (a peer that stopped)
    raises instead of hanging the host."""
    w = multihost.Watch("cpu", depth=1, timeout_s=0.05,
                        event=lambda: _Event(ready_after=None))
    w.mark()
    with pytest.raises(RuntimeError, match="did not end within 0.05 s"):
        w.mark()
    with pytest.raises(RuntimeError, match="a peer process stopped"):
        w.drain()


def test_kg_block_losses_sum_to_the_global_loss():
    """The data-parallel KG loss (dp.py:166-172): the blocks' terms, each
    over the whole batch's weight and size, sum to kg_loss of the batch,
    with uneven weights."""
    cfg = KGATConfig(embed_dim=8, relation_dim=4, conv_dims=(8,),
                     mess_dropout=(0.0,))
    model = kgat.init_params(40, 5, cfg,
                             generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    h, tp, tn = (torch.randint(0, 40, (12,), generator=g) for _ in range(3))
    r = torch.randint(0, 5, (12,), generator=g)
    w = torch.rand(12, generator=g)
    with torch.no_grad():
        want = kgat.kg_loss(model, h, r, tp, tn, cfg, weight=w)
        got = sum(dp.kg_block_loss(model, h, r, tp, tn, cfg, w,
                                   slice(i * 3, i * 3 + 3))
                  for i in range(4))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- four processes ------------------------------------------------------------

def test_group_of_four_processes(results):
    """Each worker formed the group as rank = PROCESS_ID of 4, owns slot
    pid, and re-entry with its spec returned the rank (with another spec
    raised) inside the worker; KGAT_DP_CHECK_BATCH=1 refused batches that
    differ by process on every process (dp.py:66's checksum psum)."""
    for pid in range(N_PROCS):
        assert results["lines"][("group", pid)] == (
            f"rank={pid} world={N_PROCS} slots=[{pid}] diverged=True")


@pytest.mark.parametrize("name", ["gather", "a2a", "shift"])
def test_collectives_match_their_one_process_meaning(results, name):
    """Forward and backward of each differentiable collective against
    numpy on the same rank-seeded inputs; the loss on rank r is
    sum(out_r * g_r)."""
    n = N_PROCS
    inputs, gs = [], []
    for pid in range(n):
        rs = np.random.default_rng(100 + pid)
        drawn = {}
        for key, shape in (("gather", (3, 2)), ("a2a", (2 * n, 3)),
                           ("shift", (2, 3))):
            x = rs.standard_normal(shape)
            out_shape = (3 * n, 2) if key == "gather" else shape
            drawn[key] = (x, rs.standard_normal(out_shape))
        inputs.append(drawn[name][0])
        gs.append(drawn[name][1])
    if name == "gather":
        want = [np.concatenate(inputs)] * n
        grads = [sum(g[3 * i:3 * i + 3] for g in gs) for i in range(n)]
    elif name == "a2a":
        want = [np.concatenate([inputs[j][2 * i:2 * i + 2] for j in range(n)])
                for i in range(n)]
        grads = [np.concatenate([gs[j][2 * i:2 * i + 2] for j in range(n)])
                 for i in range(n)]
    else:
        want = [inputs[(i - 1) % n] for i in range(n)]
        grads = [gs[(i + 1) % n] for i in range(n)]
    for pid in range(n):
        with np.load(results["tmp"] / f"coll.{pid}.npz") as z:
            np.testing.assert_allclose(z[name], want[pid], rtol=1e-12)
            np.testing.assert_allclose(z[f"{name}_grad"], grads[pid],
                                       rtol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_processes_agree(results, case):
    """Every process holds the same summed loss and gradients, and the
    same table after the Adam step, bit for bit; the shares add up."""
    for dropout in (0.0, 0.5):
        name = worker.label(*case, dropout)
        files = [results["files"][(name, pid)] for pid in range(N_PROCS)]
        for f in files[1:]:
            for key in f:
                if key.startswith(("grad/", "loss", "entity")):
                    np.testing.assert_array_equal(f[key], files[0][key], key)
        np.testing.assert_allclose(sum(float(f["part_loss"]) for f in files),
                                   float(files[0]["loss"]), rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_propagate_eval_matches_kgat_tpu(results, refs, case):
    name = worker.label(*case, 0.0)
    want = refs[name[:-4]]["all_embed"]
    for pid in range(N_PROCS):
        got = results["files"][(name, pid)]["all_embed"]
        assert got.shape == want.shape == (500, 16 + 16 + 8)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cf_step_matches_kgat_tpu(results, refs, case):
    """Dropout 0: the loss to 1e-5 and the entity table after one Adam
    step to 2e-5, as kgat_tpu's one-process partitioned step."""
    name = worker.label(*case, 0.0)
    ref = refs[name[:-4]]
    got = results["files"][(name, 0)]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["entity"], ref["entity"], atol=2e-5)
    assert float(results["lines"][(name, 0)].split()[0][3:]) == \
        pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cf_step_with_dropout_matches_one_process_engine(setup, results,
                                                         case):
    """Dropout 0.5, each slot's generator on its process: the attention of
    each process's shard, the loss and every gradient as the port's
    one-process Partitioned gives them."""
    name = worker.label(*case, 0.5)
    atts, loss, grads = _one_process(setup, *case, 0.5)
    rows = case[2]
    for pid in range(N_PROCS):
        f = results["files"][(name, pid)]
        p = pid % (P // rows)
        np.testing.assert_allclose(f[f"att{p}"], atts[p].numpy(), atol=1e-6)
    got = results["files"][(name, 0)]
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(got[f"grad/{k}"], g, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_kg_step_matches_kgat_tpu(setup, results, refs):
    """The data-parallel KG step over four processes: the loss to 1e-5
    and the table after Adam to 2e-5 against kgat_tpu's make_dp_kg_step;
    the gradients against the port's kg_loss on the whole batch."""
    got = results["files"][("kg", 0)]
    np.testing.assert_allclose(float(got["loss"]), refs["kg"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["entity"], refs["kg"]["entity"],
                               atol=2e-5)
    a = setup["arrays"]
    cfg = KGATConfig(ops_backend="hopper", **worker.MODEL)
    model = kgat.params_from_jax(setup["np_params"], cfg)
    t = lambda k: torch.from_numpy(a[k]).long()  # noqa: E731
    kgat.kg_loss(model, t("h"), t("r"), t("tp"), t("tn"), cfg,
                 weight=torch.from_numpy(a["kw"])).backward()
    for k, p in model.named_parameters():
        want = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got[f"grad/{k}"], want, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for pid in range(1, N_PROCS):
        np.testing.assert_array_equal(results["files"][("kg", pid)]["entity"],
                                      got["entity"])


# --- the trainer CLI on two processes -----------------------------------------

CLI = ["--device", "cpu", "--dataset", "synthetic", "--n-devices", "2",
       "--halo-exchange", "ring", "--eval-every", "1", "--syn-users", "50",
       "--syn-items", "40", "--syn-entities", "80", "--syn-relations", "3",
       "--syn-interactions", "500", "--syn-triples", "400",
       "--cf-batch-size", "62", "--kg-batch-size", "64", "--embed-dim", "16",
       "--relation-dim", "16", "--conv-dims", "16,8", "--lr", "5e-3",
       "--run-name", "mp"]


def _cli(tmp_path, rendezvous, *flags, check_batch="0"):
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kgat_tpu_torch.train", *CLI, "--log-dir",
         str(tmp_path), *flags], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO, env=_env(
            COORDINATOR_ADDRESS=f"file://{tmp_path}/{rendezvous}",
            NUM_PROCESSES="2", PROCESS_ID=str(pid),
            KGAT_DP_CHECK_BATCH=check_batch))
        for pid in range(2)]
    return _finish(procs)


def test_cli_on_two_processes_shards_and_resumes(tmp_path):
    """``--n-devices 2 --halo-exchange ring`` on a group of two: process
    0 alone logs (one start, one done), its epoch events carry the
    process count and rank, both processes write their checkpoint shards
    in kgat_tpu's format, and ``--resume`` to epoch 4 appends a resume
    event and trains on. The first run checks every step's batches
    (KGAT_DP_CHECK_BATCH=1): the processes draw alike."""
    outs = _cli(tmp_path, "rdzv1", "--epochs", "2", check_batch="1")
    assert "epoch:" in outs[0] and "epoch:" not in outs[1]
    log = tmp_path / "mp.jsonl"
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names.count("start") == 1 and names.count("done") == 1
    epochs = [e for e in events if e["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == [1, 2]
    assert all(e["processes"] == 2 and e["rank"] == 0 and not e["captured"]
               for e in epochs)
    assert np.isfinite([e["cf_loss"] for e in epochs]).all()
    for kind in ("mp_best", "mp_best_last"):
        for i in range(2):
            assert (tmp_path / f"{kind}.shard{i}of2.npz").exists(), kind
        assert not (tmp_path / f"{kind}.npz").exists()
    side = json.loads((tmp_path / "mp_best_last.json").read_text())
    assert side["n_shards"] == 2 and side["epoch"] == 2
    state = ckpt.load_checkpoint_sharded(str(tmp_path / "mp_best_last"))
    assert sorted(state["own"]) == ["generator", "part_generator/0",
                                    "part_generator/1"]
    assert state["params"]["entity_embed"].shape == (130, 16)

    _cli(tmp_path, "rdzv2", "--epochs", "4", "--resume")
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names.count("resume") == 1 and names.count("done") == 2
    assert "rng_reseeded" not in names
    resumed = next(e for e in events if e["event"] == "resume")
    assert resumed["epoch"] == 2
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2,
                                                                     3, 4]


@pytest.mark.parametrize("flags", [
    ["--halo-exchange", "ring", "--ring-transport", "fused"],
    ["--halo-exchange", "ring", "--ring-transport", "dma"],
    ["--halo-exchange", "a2a"],
    ["--halo-exchange", "allgather", "--dp-replicas", "2"]],
    ids=["ring-fused", "ring-dma", "a2a", "allgather-2x2"])
def test_two_slots_per_process_match_one_process(tmp_path, flags):
    """--n-devices 4 on two processes, two slots each: between a
    process's own slots the in-process paths, across the pair the
    collectives (on the (2, 2) mesh each process holds a whole row). One
    epoch with dropout on gives the one-process trainer's losses (the
    same batches, each slot's dropout stream on its own process) within
    rtol 1e-5, the partial sums added in another order."""
    common = [*flags, "--n-devices", "4", "--epochs", "1", "--run-name",
              "slots"]
    (tmp_path / "two").mkdir()
    _cli(tmp_path / "two", "rdzv", *common)
    train.main([*CLI, *common, "--log-dir", str(tmp_path / "one")])
    got, want = ([json.loads(ln) for ln in (tmp_path / d / "slots.jsonl")
                  .read_text().splitlines()] for d in ("two", "one"))
    got_e, want_e = (next(e for e in ev if e["event"] == "epoch")
                     for ev in (got, want))
    assert got_e["processes"] == 2 and "processes" not in want_e
    for key in ("cf_loss", "kg_loss"):
        np.testing.assert_allclose(got_e[key], want_e[key], rtol=1e-5,
                                   err_msg=key)


# --- each package reads the other's shards ---------------------------------------

def _state(seed):
    rs = np.random.default_rng(seed)
    params = {"entity_embed": rs.standard_normal((7, 4)).astype(np.float32),
              "rel_embed": rs.standard_normal((3, 2)).astype(np.float32),
              "w_rel": rs.standard_normal((3, 4, 2)).astype(np.float32),
              "layers": [{"w1": rs.standard_normal((4, 4)).astype(np.float32),
                          "b1": rs.standard_normal(4).astype(np.float32)}]}
    mu = jax.tree.map(lambda x: x * 0.5, params)
    nu = jax.tree.map(lambda x: x * x, params)
    return params, mu, nu


def test_kgat_tpu_reads_the_ports_shards(tmp_path):
    params, mu, nu = _state(1)
    path = str(tmp_path / "ck")
    for i in range(2):
        ckpt.save_checkpoint_sharded(
            path, params, mu, nu, 7, epoch=3,
            rng=np.array([5, 3], np.uint32), best_metric=0.25, bad_evals=1,
            process_index=i, process_count=2,
            own={f"part_generator/{i}": np.arange(4, dtype=np.uint8) + i})
    opt = optax.adam(1e-3)
    like = jax.tree.map(jnp.zeros_like, params)
    got_p, got_o, meta, rng = jckpt.load_checkpoint_sharded(
        path, like, opt.init(like))
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_o[0].mu["w_rel"], mu["w_rel"])
    np.testing.assert_array_equal(got_o[0].nu["entity_embed"],
                                  nu["entity_embed"])
    assert int(got_o[0].count) == 7 and meta["epoch"] == 3
    np.testing.assert_array_equal(jax.random.key_data(rng), [5, 3])
    port = ckpt.load_checkpoint_sharded(path)
    assert port["own"]["part_generator/1"].tolist() == [1, 2, 3, 4]
    assert port["count"] == 7 and port["meta"]["best_metric"] == 0.25


def test_port_reads_kgat_tpus_shards(tmp_path):
    params, mu, nu = _state(2)
    opt = optax.adam(1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    state = (state[0]._replace(count=jnp.asarray(5, jnp.int32),
                               mu=jax.tree.map(jnp.asarray, mu),
                               nu=jax.tree.map(jnp.asarray, nu)),
             *state[1:])
    path = str(tmp_path / "jk")
    for i in range(2):
        jckpt.save_checkpoint_sharded(path, jparams, state, epoch=4,
                                      rng=jax.random.key(3), best_metric=0.5,
                                      bad_evals=2, process_index=i,
                                      process_count=2)
    got = ckpt.load_checkpoint_sharded(path)
    for k in ("params", "mu", "nu"):
        want = {"params": params, "mu": mu, "nu": nu}[k]
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert got["count"] == 5 and got["own"] == {}
    assert got["meta"]["epoch"] == 4 and got["meta"]["bad_evals"] == 2
    np.testing.assert_array_equal(got["rng"],
                                  jax.random.key_data(jax.random.key(3)))
