"""The trainer's other modes against ``kgat_tpu`` on the CPU: the host
samplers (``--sampler host``), lazy sparse Adam (``--sparse-adam``),
BPR-MF pretrain (``--use-pretrain``), and the bodies of the steps that
CUDA graphs capture on the card, run eagerly.

Runs are tiny and synthetic (the two packages' synthetic datasets are bit
equal, tests/test_torch_data_graph.py) on the plain ops (``ops_backend
ref``); each test states its tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgat_tpu.models import bprmf as jbprmf
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.optim import make_sparse_kg_step
from kgat_tpu.sampler import HostCFSampler as JHostCFSampler
from kgat_tpu.sampler import HostKGSampler as JHostKGSampler
from kgat_tpu.train import Trainer as JTrainer
from kgat_tpu.utils.config import TrainConfig as JTrainConfig
from kgat_tpu_torch import train
from kgat_tpu_torch.data import synthetic_dataset
from kgat_tpu_torch.models import bprmf
from kgat_tpu_torch.models import kgat
from kgat_tpu_torch.optim import (adam_count, make_optimizer,
                                  set_adam_count, sparse_kg_step,
                                  sparse_kg_step_plain)
from kgat_tpu_torch.sampler import HostCFSampler, HostKGSampler
from kgat_tpu_torch.utils.config import TrainConfig

import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYN = dict(syn_users=60, syn_items=40, syn_entities=90, syn_relations=3,
           syn_interactions=800, syn_triples=400)
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8))


def _cfgs(mess_dropout=(0.1, 0.1), **kw):
    """The same run for both packages: (port TrainConfig, kgat_tpu's)."""
    common = dict(dataset="synthetic", log_dir=None, seed=5, lr=1e-3,
                  cf_batch_size=128, kg_batch_size=256, **SYN, **kw)
    port = TrainConfig(device="cpu", model=kgat.KGATConfig(
        ops_backend="ref", mess_dropout=mess_dropout, **MODEL), **common)
    ref = JTrainConfig(model=jkgat.KGATConfig(
        ops_backend="ref", mess_dropout=mess_dropout, **MODEL), **common)
    return port, ref


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Host samplers.
# ---------------------------------------------------------------------------

def test_host_samplers_draw_kgat_tpus_batches():
    """One seed, one training set: the port's host samplers draw
    kgat_tpu's batches, exactly, batch after batch."""
    ds = synthetic_dataset(seed=2, n_users=60, n_items=40, n_entities=90,
                           n_relations_kg=3, n_interactions=800,
                           n_triples=400)
    g, meta = ds.build()
    tri = np.stack([g.dst.numpy(), g.etype.numpy(), g.src.numpy()], 1)
    pairs = ((HostCFSampler(ds.train_user_dict, ds.n_items, 11),
              JHostCFSampler(ds.train_user_dict, ds.n_items, 11), 64),
             (HostKGSampler(tri, meta.n_nodes, 11),
              JHostKGSampler(tri, meta.n_nodes, 11), 128))
    for port, ref, batch in pairs:
        for _ in range(3):
            for a, b in zip(port.sample(batch), ref.sample(batch)):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def host_epochs():
    """One host-sampled epoch in each trainer from the same parameters,
    message dropout 0, with every step's loss recorded."""
    port_cfg, ref_cfg = _cfgs(sampler="host", mess_dropout=(0.0, 0.0))
    jtr = JTrainer(ref_cfg)
    tr = train.Trainer(port_cfg)
    kgat.copy_params_(tr.model, _jax_numpy(jtr.params))
    losses = {"port": [], "jax": []}

    def record(fn, out, index=None):
        def step(*args, **kw):
            res = fn(*args, **kw)
            out.append(float(res if index is None else res[index]))
            return res
        return step

    tr.cf_step = record(tr.cf_step, losses["port"])
    tr.kg_step = record(tr.kg_step, losses["port"])
    jtr._cf_step_host = record(jtr._cf_step_host, losses["jax"], 2)
    jtr._kg_step_host = record(jtr._kg_step_host, losses["jax"], 2)
    means = {"port": tr.train_one_epoch(), "jax": jtr.train_one_epoch()}
    return dict(tr=tr, jtr=jtr, losses=losses, means=means)


def test_both_trainers_build_the_same_kg_triples(host_epochs):
    """The KG sampler's triples are (dst, etype, src) in the CKG's
    canonical order in both trainers, and so are the CF sampler's users."""
    tr, jtr = host_epochs["tr"], host_epochs["jtr"]
    np.testing.assert_array_equal(tr._host_kg.triples, jtr._host_kg.triples)
    np.testing.assert_array_equal(tr._host_cf.users, jtr._host_cf.users)


def test_host_sampled_epoch_matches_kgat_tpu(host_epochs):
    """Per-step losses at rtol 1e-4 and the epoch's means; the final
    parameters within what Adam can move them apart: each step moves a
    value by at most about lr (the update is lr * m / (sqrt(v) + eps)),
    so where a float32 gradient near 0 takes the other sign in one
    package, the two can part by up to 2 lr a step. The bound is 2 lr
    times the steps, plus rtol 1e-4."""
    tr, jtr = host_epochs["tr"], host_epochs["jtr"]
    got, want = host_epochs["losses"]["port"], host_epochs["losses"]["jax"]
    assert len(got) == len(want) == tr.n_cf_batches + tr.n_kg_batches
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(host_epochs["means"]["port"],
                               host_epochs["means"]["jax"], rtol=1e-4)
    bound = 2 * tr.cfg.lr * len(got)
    port, ref = kgat.numpy_params(tr.model), _jax_numpy(jtr.params)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=bound)


# ---------------------------------------------------------------------------
# Lazy sparse Adam.
# ---------------------------------------------------------------------------

def _sparse_setup(seed=0, n_nodes=50, n_rel=5, B=8):
    """kgat_tpu's tests/test_sparse_adam.py setup: ids from a small pool,
    so the batch repeats rows."""
    cfg = jkgat.KGATConfig(embed_dim=8, relation_dim=6, conv_dims=(4,),
                           mess_dropout=(0.0,))
    params = jkgat.init_params(jax.random.key(seed), n_nodes, n_rel, cfg)
    rs = np.random.default_rng(seed)
    batch = (rs.integers(0, 10, B), rs.integers(0, n_rel, B),
             rs.integers(0, 12, B), rs.integers(0, 12, B))
    tcfg = kgat.KGATConfig(embed_dim=8, relation_dim=6, conv_dims=(4,),
                           mess_dropout=(0.0,))
    model = kgat.params_from_jax(_jax_numpy(params), tcfg)
    return cfg, params, tcfg, model, batch


def _adam_ratio(m, v, count):
    """Adam's step direction m_hat / (sqrt(v_hat) + eps), in float64."""
    m, v = (np.asarray(x, np.float64) for x in (m, v))
    return (m / (1 - 0.9 ** count)) / (np.sqrt(v / (1 - 0.999 ** count))
                                       + 1e-8)


@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_kg_step_matches_kgat_tpu(weighted):
    """Four lazy steps on a batch with repeated rows against
    kgat_tpu.optim.make_sparse_kg_step: loss, mu and nu at rtol 1e-5
    (atol 1e-7 and 1e-10 for values near 0), and the count; the conv
    weights stay as they were. Parameters at rtol 1e-5 plus what the
    moments' differences explain: a step moves a value by lr times Adam's
    ratio m_hat / (sqrt(v_hat) + eps), which amplifies a rounding of a
    gradient near 0 (up to 5.8e-4 here, lr 1e-2, where weights make a
    duplicated row's terms cancel), so the allowance adds, step by step,
    lr times the difference of the ratios each package's moments give."""
    cfg, params, tcfg, model, batch = _sparse_setup()
    lr = 1e-2
    w = (np.random.default_rng(3).uniform(0.5, 1.0, len(batch[0]))
         .astype(np.float32) if weighted else None)
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    tb = tuple(torch.as_tensor(x) for x in batch)
    jstep = jax.jit(make_sparse_kg_step(cfg, lr))
    state = optax.adam(lr).init(params)
    opt = make_optimizer(model.parameters(), lr)
    conv = {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith("layers.")}
    names = ("entity_embed", "rel_embed", "w_rel")
    allow = {n: 1e-7 for n in names}
    for count in range(1, 5):
        params, state, jloss = jstep(params, state, *jb,
                                     None if w is None else jnp.asarray(w))
        loss = sparse_kg_step(model, opt, *tb, tcfg,
                              None if w is None else torch.as_tensor(w))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for name in names:
            p = getattr(model, name)
            m, v = (opt.state[p][k].numpy() for k in ("exp_avg",
                                                      "exp_avg_sq"))
            jm, jv = np.asarray(state[0].mu[name]), np.asarray(
                state[0].nu[name])
            np.testing.assert_allclose(m, jm, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
            np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-10,
                                       err_msg=name)
            allow[name] = allow[name] + lr * np.abs(
                _adam_ratio(m, v, count) - _adam_ratio(jm, jv, count))
            got, want = p.detach().numpy(), np.asarray(params[name])
            assert (np.abs(got - want) <= allow[name] + 1e-5 * np.abs(
                want)).all(), name
    assert {int(s["step"]) for s in opt.state.values()} == {
        int(state[0].count)} == {4}
    for n, p in model.named_parameters():
        if n in conv:
            assert torch.equal(p, conv[n]), n


def test_sparse_kg_step_keeps_stale_moments_and_steps_every_count():
    """TF-LazyAdam: rows outside the batch keep value and moments; the
    conv weights keep value and moments while their step advances (the
    shared count); a dense Adam step (the CF phase's) then works on the
    same state and advances the count again."""
    _, _, tcfg, model, batch = _sparse_setup()
    opt = make_optimizer(model.parameters(), 1e-2)
    tb = tuple(torch.as_tensor(x) for x in batch)
    for p in model.parameters():          # moments a CF step would leave
        opt.state[p]["exp_avg"].fill_(0.25)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sparse_kg_step(model, opt, *tb, tcfg)
    touched = np.unique(np.concatenate([batch[0], batch[2], batch[3]]))
    untouched = np.setdiff1d(np.arange(50), touched)
    emb = model.entity_embed.detach()
    assert torch.equal(emb[untouched], before["entity_embed"][untouched])
    assert not torch.equal(emb[touched], before["entity_embed"][touched])
    m = opt.state[model.entity_embed]["exp_avg"]
    assert (m[untouched] == 0.25).all() and (m[touched] != 0.25).any()
    for n, p in model.named_parameters():
        if n.startswith("layers."):
            assert torch.equal(p, before[n]), n
            assert (opt.state[p]["exp_avg"] == 0.25).all(), n
    assert {int(s["step"]) for s in opt.state.values()} == {1}
    opt.zero_grad(set_to_none=False)
    opt.step()                              # a dense step, zero gradients
    assert {int(s["step"]) for s in opt.state.values()} == {2}
    assert not torch.equal(model.layers[0]["w1"], before["layers.0.w1"])


def test_sparse_kg_step_advances_a_shared_count_once():
    """Where every parameter's state holds one step tensor (as
    ``optim.KernelAdam``'s on CUDA), the lazy step advances it once, and
    set_adam_count sets it: the count stays optax's one count."""
    _, _, tcfg, model, batch = _sparse_setup()
    opt = make_optimizer(model.parameters(), 1e-2)
    shared = torch.zeros(())
    for s in opt.state.values():
        s["step"] = shared
    sparse_kg_step(model, opt, *(torch.as_tensor(x) for x in batch), tcfg)
    assert adam_count(opt) == 1 and float(shared) == 1.0
    set_adam_count(opt, 7)
    assert adam_count(opt) == 7 and float(shared) == 7.0


@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_kg_step_matches_its_float64_oracle(weighted):
    """sparse_kg_step_plain (dense gradients, Adam on the rows the batch
    names; chip_smoke holds the card's step to it) against the lazy step:
    loss and moments at rtol 1e-5, parameters at rtol 1e-5 and atol
    1e-6 (lr 1e-2 times the rounding of m / sqrt(v))."""
    _, _, tcfg, model, batch = _sparse_setup(seed=1)
    opt = make_optimizer(model.parameters(), 1e-2)
    tb = tuple(torch.as_tensor(x) for x in batch)
    w = torch.linspace(0.5, 1.0, len(batch[0])) if weighted else None
    loss64, want, touched = sparse_kg_step_plain(model, opt, *tb, tcfg, w)
    loss = sparse_kg_step(model, opt, *tb, tcfg, w)
    assert abs(float(loss) - loss64) <= 1e-5 * abs(loss64)
    np.testing.assert_array_equal(
        touched, np.unique(np.concatenate([batch[0], batch[2], batch[3]])))
    for name, (p, m, v) in want.items():
        t = getattr(model, name)
        torch.testing.assert_close(t.detach().double(), p, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(opt.state[t]["exp_avg"].double(), m,
                                   rtol=1e-5, atol=1e-8)
        torch.testing.assert_close(opt.state[t]["exp_avg_sq"].double(), v,
                                   rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# BPR-MF pretrain.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_bpr_loss_and_gradient_match_jax(weighted):
    """bpr_loss and its gradient against kgat_tpu's on one batch, rtol
    1e-5 (atol 1e-8 for the gradient's zero rows)."""
    rs = np.random.default_rng(4)
    p = {"user_embed": rs.normal(size=(20, 16)).astype(np.float32),
         "item_embed": rs.normal(size=(15, 16)).astype(np.float32) * 0.3}
    u, ip, ineg = (rs.integers(0, n, 32) for n in (20, 15, 15))
    w = (rs.uniform(0, 1, 32) if weighted else np.ones(32)).astype(
        np.float32)
    jl, jg = jax.value_and_grad(jbprmf.bpr_loss)(
        jax.tree.map(jnp.asarray, p), *map(jnp.asarray, (u, ip, ineg, w)))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    loss = bprmf.bpr_loss(tp, *map(torch.as_tensor, (u, ip, ineg, w)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_pretrain_rows_placed():
    """init_params(pretrain=...) puts item rows at [0, n_items) and user
    rows at n_entities + uid, as kgat_tpu's does
    (tests/test_pretrain.py:12); other rows stay random; a width that is
    not embed_dim is refused."""
    rs = np.random.default_rng(0)
    cfg = kgat.KGATConfig(embed_dim=16, relation_dim=16, conv_dims=(8,),
                          mess_dropout=(0.1,))
    ue = rs.normal(size=(30, 16)).astype(np.float32)
    ie = rs.normal(size=(25, 16)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    model = kgat.init_params(80, 4, cfg, generator=gen, pretrain=(ue, ie, 50))
    jparams = jkgat.init_params(
        jax.random.key(0), 80, 4, jkgat.KGATConfig(
            embed_dim=16, relation_dim=16, conv_dims=(8,),
            mess_dropout=(0.1,)), pretrain=(ue, ie, 50))
    emb = model.entity_embed.detach().numpy()
    jemb = np.asarray(jparams["entity_embed"])
    for rows in (slice(0, 25), slice(50, 80)):
        np.testing.assert_array_equal(emb[rows], jemb[rows])
    assert np.abs(emb[25:50]).sum() > 0
    with pytest.raises(ValueError, match="embed_dim"):
        kgat.init_params(80, 4, cfg, generator=gen,
                         pretrain=(ue[:, :8], ie, 50))


@pytest.mark.parametrize("name,users,items", [("ab-mf", 300, 200),
                                              ("lastfm-mf", 23566, 48123)])
def test_committed_pretrain_npz_loads(name, users, items):
    """The committed npz files of kgat_tpu's runs load unchanged: their
    rows land where kgat_tpu puts them (the item rows as entity ids)."""
    with np.load(os.path.join(REPO, "runs", f"{name}.npz")) as z:
        ue, ie = z["user_embed"], z["item_embed"]
    assert ue.shape == (users, 64) and ie.shape == (items, 64)
    cfg = kgat.KGATConfig(conv_dims=(8,), mess_dropout=(0.1,))
    model = kgat.init_params(items + users, 3, cfg,
                             generator=torch.Generator().manual_seed(0),
                             pretrain=(ue, ie, items))
    emb = model.entity_embed.detach().numpy()
    np.testing.assert_array_equal(emb[:items], ie)
    np.testing.assert_array_equal(emb[items:], ue)


def test_bprmf_pretrainer_learns():
    """The port's BPR-MF trainer starts near ln 2 and its loss falls, as
    kgat_tpu's (tests/test_pretrain.py:37)."""
    ds = synthetic_dataset(seed=7, n_users=30, n_items=25, n_entities=50,
                           n_relations_kg=4, n_interactions=300,
                           n_triples=200)
    losses = []
    embeds = bprmf.train_bprmf(ds.cf_train, ds.n_users, ds.n_items, dim=16,
                               epochs=8, batch_size=64, device="cpu",
                               log=lambda e, l: losses.append(l))
    assert losses[-1] < losses[0] < 0.75
    assert embeds["user_embed"].shape == (30, 16)
    assert embeds["item_embed"].shape == (25, 16)


def test_pretrain_npz_crosses_between_packages(tmp_path):
    """An npz from the port's CLI trains in kgat_tpu with --use-pretrain,
    and one from kgat_tpu's CLI trains in the port: each trainer starts
    from the other's rows and runs an epoch."""
    flags = ["--dataset", "synthetic", "--epochs", "2", "--dim", "16",
             "--batch-size", "256"]
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert bprmf.main([*flags, "--device", "cpu", "--out", port_npz]) == 0
    assert jbprmf.main([*flags, "--out", jax_npz]) == 0
    model = dict(embed_dim=16, relation_dim=16, conv_dims=(16,),
                 mess_dropout=(0.1,))
    common = dict(dataset="synthetic", log_dir=None, epochs=1,
                  cf_batch_size=1024, kg_batch_size=2048)
    trainers = (
        (JTrainer(JTrainConfig(pretrain_path=port_npz, **common,
                               model=jkgat.KGATConfig(ops_backend="ref",
                                                      **model))),
         port_npz),
        (train.Trainer(TrainConfig(device="cpu", pretrain_path=jax_npz,
                                   **common, model=kgat.KGATConfig(
                                       ops_backend="ref", **model))),
         jax_npz))
    for tr, npz in trainers:
        emb = (np.asarray(tr.params["entity_embed"]) if hasattr(tr, "params")
               else tr.model.entity_embed.detach().numpy())
        # The synthetic defaults: 300 users, 200 items, 500 entities.
        with np.load(npz) as z:
            np.testing.assert_array_equal(emb[:200], z["item_embed"])
            np.testing.assert_array_equal(emb[500:800], z["user_embed"])
        cf, kg = tr.train_one_epoch()
        assert np.isfinite([cf, kg]).all()


# ---------------------------------------------------------------------------
# The captured steps' bodies, eagerly on the CPU.
# ---------------------------------------------------------------------------

def test_step_bodies_equal_cf_step_and_kg_step():
    """The bodies that CUDA graphs capture on the card, run eagerly: the
    batch and dropout masks they expose, fed to cf_step and kg_step of a
    second trainer from the same seed, give equal losses and parameters;
    and the bodies draw what cf_step draws given the batch alone."""
    port_cfg, _ = _cfgs()
    a, b, c = (train.Trainer(port_cfg) for _ in range(3))
    for tr in (a, b, c):
        tr.stage(tr.attention())
    losses = [float(a._cf_body()), float(a._kg_body())]
    u, i_pos, i_neg, w, masks = a.cf_drawn
    assert len(masks) == 2 and masks[0].shape == (a.meta.n_nodes, 16)
    assert [float(b.cf_step(b._step_att, u, i_pos, i_neg, w, masks=masks)),
            float(b.kg_step(*a.kg_drawn))] == losses
    # c draws its own batch; cf_step draws the masks inside the forward.
    assert [float(c.cf_step(c._step_att, *c.sample_cf())),
            float(c.kg_step(*c.sample_kg()))] == losses
    for m in (b, c):
        for p, q in zip(a.model.parameters(), m.model.parameters()):
            assert torch.equal(p, q)
