"""The port's bench (``python -m kgat_tpu_torch.bench``) against
``bench.py`` and ``kgat_tpu``, on the CPU at the ``smoke`` preset.

The same preset graph (the two packages' synthetic data are bit-equal
for one seed), ``kgat_tpu``'s ``init_params(key(0))`` carried across by
``params_from_jax``, message dropout 0 on both sides. On the ref
backends, the payload of each timed call within rtol 1e-4: the attention
weights (E,) in canonical edge order, the forward's all_embed, the CF
loss on ``bench.py``'s fixed batch. On the bench's default path (hopper
with bf16 and coalescing, the plain versions on the CPU) against
``kgat_tpu``'s pallas backend in interpret mode: each attention weight
within bf16's rounding (2^-8, and 1e-4 of float32 before it) of
``kgat_tpu``'s float32 one, all_embed within rtol 1e-3 (atol 1e-4, as
``tests/test_torch_bf16_weights.py``), the loss within rtol 1e-4. The
bench's ring/fused engine at P = 1 and 4 against the single-device
kernel path: the first CF loss within rtol 1e-4, all_embed within 2^-8.
``_score_block`` against ``kgat_tpu.recommend``'s: the top-K ids equal,
the scores within 1e-5. The exchange bytes against ``bench.py``'s. The
CLI in a subprocess where importing jax, ``kgat_tpu`` or ``bench.py``
raises; the roofline probes and ``bench_attention`` at small sizes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu.models import kgat as jkgat
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.recommend import _score_block as j_score_block
from kgat_tpu_torch import bench as tbench
from kgat_tpu_torch import bench_attention
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.parallel import partition as tpart
from kgat_tpu_torch.recommend import _score_block as t_score_block
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # one intra-op thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the repository's bench.py)

BATCH = 1024
NO_DROPOUT = (0.0, 0.0, 0.0)
# A bf16 weight against a float32 one: bf16's unit roundoff 2^-8, after
# a float32 difference of up to 1e-4.
BF16_ATT_RTOL = 2.0 ** -8 + 1e-4
# bench.py's JSON keys: always; with --compare; of --n-devices; --serving.
KEYS = {"metric", "value", "unit", "vs_baseline", "preset", "backend",
        "device", "n_edges", "attention_edges_per_s", "forward_edges_per_s",
        "t_cf_step_ms", "t_cf_step_min_ms", "t_cf_step_pass_medians_ms",
        "cf_step_spread_pct", "variance_alarm", "graph_cache_state",
        "t_attention_ms", "t_staging_ms", "t_forward_ms"}
COMPARE_KEYS = {"ref_t_cf_step_ms", "ref_t_attention_ms", "ref_t_forward_ms"}
SCALING_KEYS = {"n_devices", "n_ep", "dp_replicas", "exchange",
                "ring_transport", "t_cf_step_ms", "cf_step_spread_pct",
                "t_attention_ms", "t_propagate_ms", "overhead_vs_single",
                "t_single_cf_step_ms", "cf_step_edges_per_s",
                "cf_step_edges_per_s_per_chip", "attention_edges_per_s",
                "ici_bytes_per_step_per_device", "ici_bytes_dp_allreduce",
                "ici_model_gb_s", "pred_eff_4chips", "pred_eff_8chips",
                "pred_eff_16chips"}
SERVING_KEYS = {"serving_users_per_s", "serving_t_forward_ms",
                "serving_t_score_block_ms", "serving_forward_cached",
                "serving_block", "serving_k"}


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def smoke():
    """Both packages' smoke preset, cache off."""
    _, jg, jmeta = jbench.build("smoke")
    ds, tg, tmeta, stages = tbench.build("smoke")
    return jg, jmeta, ds, tg, tmeta, stages


def test_preset_graph_has_bench_py_edge_count(smoke):
    jg, jmeta, _, tg, tmeta, stages = smoke
    assert tg.n_edges == jg.n_edges
    assert (tmeta.n_nodes, tmeta.n_relations) == (jmeta.n_nodes,
                                                  jmeta.n_relations)
    assert stages["graph_cache"] == "off"
    assert set(tbench.PRESETS) == set(jbench.PRESETS)
    assert all(tbench.PRESETS[k] == jbench.PRESETS[k] for k in jbench.PRESETS)


def jax_payloads(jg, jmeta, params, jcfg):
    """kgat_tpu's counterparts of the port's payloads: the attention in
    canonical edge order (float32), propagate over the staged attention,
    the CF loss on the fixed batch (dropout 0)."""
    att = jkgat.attention_for_training(params, jg, jcfg)
    a = jnp.arange(BATCH, dtype=jnp.int32)
    return {
        "attention": np.asarray(jkgat.compute_attention(
            params, jg, jcfg))[: jg.n_edges],
        "forward": np.asarray(jkgat.propagate(params, jg, att, jcfg)),
        "cf_loss": float(jkgat.cf_loss(
            params, jg, att, jmeta, a % jmeta.n_users, a % jmeta.n_items,
            (a + 7) % jmeta.n_items, jcfg, rng=jax.random.key(0),
            train=True)),
    }


def port_payloads(tg, tmeta, params, backend, compute_dtype):
    cfg = tbench.model_config(backend, compute_dtype,
                              mess_dropout=NO_DROPOUT)
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    res = tbench.bench_backend(tg, tmeta, backend, BATCH, 1,
                               compute_dtype=compute_dtype, model=model,
                               mess_dropout=NO_DROPOUT)
    assert res["cf_step_edges_per_s"] == pytest.approx(
        3 * tg.n_edges / res["t_cf_step_s"])
    return res["payloads"]


@pytest.fixture(scope="module")
def jax_params(smoke):
    jg, jmeta, *_ = smoke
    return jkgat.init_params(jax.random.key(0), jmeta.n_nodes,
                             jmeta.n_relations,
                             jkgat.KGATConfig(mess_dropout=NO_DROPOUT))


def test_timed_payloads_match_kgat_tpu(smoke, jax_params):
    """Each timed call's first result on the ref backends, from
    ``kgat_tpu``'s weights: the attention weights, the forward, the loss
    of the first CF step on the fixed batch (before its Adam update)."""
    jg, jmeta, _, tg, tmeta, _ = smoke
    want = jax_payloads(jg, jmeta, jax_params, jkgat.KGATConfig(
        ops_backend="ref", mess_dropout=NO_DROPOUT))
    got = port_payloads(tg, tmeta, jax_params, "ref", "f32")
    np.testing.assert_allclose(got["attention"].numpy(), want["attention"],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["forward"].numpy(), want["forward"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["cf_loss"], want["cf_loss"], rtol=1e-4)


def test_hopper_payloads_match_kgat_tpu_pallas(smoke, jax_params):
    """The bench's default path (hopper, bf16 value stream, coalescing:
    the plain versions on the CPU) against ``kgat_tpu``'s pallas backend
    at its defaults (bf16, coalescing), its kernels in interpret mode."""
    jg, jmeta, _, tg, tmeta, _ = smoke
    jcfg = jkgat.KGATConfig(ops_backend="pallas", compute_dtype=jnp.bfloat16,
                            mess_dropout=NO_DROPOUT)
    assert jcfg.coalesce and jcfg.coalesce_cap == 8
    with pltpu.force_tpu_interpret_mode():
        want = jax_payloads(jg, jmeta, jax_params, jcfg)
    got = port_payloads(tg, tmeta, jax_params, "hopper", "bf16")
    att = got["attention"].numpy()
    np.testing.assert_array_equal(
        att, torch.from_numpy(att).bfloat16().float().numpy())
    np.testing.assert_allclose(att, want["attention"], rtol=BF16_ATT_RTOL,
                               atol=0)
    np.testing.assert_allclose(got["forward"].numpy(), want["forward"],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["cf_loss"], want["cf_loss"], rtol=1e-4)


@pytest.mark.parametrize("n_parts", [1, 4])
def test_ring_fused_engine_matches_single_device(smoke, n_parts):
    """The bench's partitioned engine (ring exchange, fused transport, the
    bench's hopper config, dropout 0) on the bench's partitioned batch:
    the first CF loss and the eval all_embed against the single-device
    kernel path's. P = 1 is one bucket holding the whole graph."""
    _, _, ds, tg, tmeta, _ = smoke
    cfg = tbench.model_config("hopper", mess_dropout=NO_DROPOUT)
    model = tbench.init_model(tmeta, cfg, "cpu")
    u, ip, ineg, w = tbench.partitioned_batch(ds, tmeta, BATCH, n_parts,
                                              torch.device("cpu"))
    part, info, _ = tbench.partitioned_engine(tg, tmeta, cfg, n_parts,
                                              "ring", "fused")
    assert (part.n_parts, part.n_rows, info.n_parts) == (n_parts, 1, n_parts)
    with torch.no_grad():
        att = tkgat.attention_for_training(model, tg, cfg)
        single = float(tkgat.cf_loss(model, tg, att, tmeta, u, ip, ineg, cfg,
                                     train=True, weight=w))
        want = tkgat.propagate(model, tg, att, cfg)
        _, staged = part.attention(model)
        loss = float(part.cf_loss(model, staged, u, ip, ineg, weight=w))
        got = part.propagate_eval(model, staged)
    part.close()
    np.testing.assert_allclose(loss, single, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2.0 ** -8)


def test_score_block_matches_kgat_tpu():
    """One block of users with mask pairs, one of them twice."""
    rs = np.random.default_rng(5)
    n_nodes, n_items, B, k = 300, 120, 16, 10
    emb = rs.standard_normal((n_nodes, 24)).astype(np.float32)
    nodes = rs.integers(n_items, n_nodes, B).astype(np.int32)
    live = np.stack([rs.integers(0, B, 40), rs.integers(0, n_items, 40)], 1)
    pairs = np.concatenate([live, live[:1]]).astype(np.int32)
    j_items, j_scores = j_score_block(jnp.asarray(emb), jnp.asarray(nodes),
                                      jnp.asarray(pairs), n_items, k)
    t_items, t_scores = t_score_block(torch.from_numpy(emb),
                                      torch.from_numpy(nodes),
                                      torch.from_numpy(pairs), n_items, k)
    np.testing.assert_array_equal(t_items.numpy(), np.asarray(j_items))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               rtol=0, atol=1e-5)
    masked = set(map(tuple, live.tolist()))
    assert not any((r, i) in masked for r in range(B)
                   for i in t_items[r].tolist())


@pytest.mark.parametrize("n_parts", [2, 4])
def test_exchange_bytes_match_bench_py(smoke, n_parts):
    """allgather and ring equal bench.py's at the same R; a2a is
    (P - 1) H d bytes with the port's unpadded H, at most bench.py's."""
    jg, jmeta, _, tg, tmeta, _ = smoke
    src, dst, ety = (t.numpy() for t in (tg.src, tg.dst, tg.etype))
    _, jinfo = jpart.partition_graph(src, dst, ety, jmeta.n_nodes,
                                     jmeta.n_relations, n_parts)
    shards, tinfo = tpart.partition_graph(src, dst, ety, tmeta.n_nodes,
                                          tmeta.n_relations, n_parts)
    assert tinfo.rows_per_part == jinfo.rows_per_part
    dims = [64, 64, 32]
    for exchange in ("allgather", "ring"):
        for nbytes in (2, 4):
            assert tbench._exchange_bytes_per_layer(
                exchange, tinfo, dims, nbytes) == \
                jbench._exchange_bytes_per_layer(exchange, jinfo, dims,
                                                 nbytes)
    t_halo = tpart.build_selective_halo(shards, tinfo)[0]
    j_halo = jpart.build_selective_halo(src, dst, jinfo)
    got = tbench._exchange_bytes_per_layer("a2a", tinfo, dims, 2,
                                           sel_halo=t_halo)
    want = jbench._exchange_bytes_per_layer("a2a", jinfo, dims, 2,
                                            sel_halo=j_halo)
    assert got == {li: (n_parts - 1) * t_halo.halo_rows * d * 2
                   for li, d in enumerate(dims)}
    assert 0 < t_halo.halo_rows <= j_halo.halo_rows
    assert all(got[li] <= want[li] for li in got)


BLOCKED = """
import runpy, sys
for name in ("jax", "kgat_tpu", "bench", "bench_attention"):
    sys.modules[name] = None     # any import of them raises ImportError
sys.path.insert(0, {repo!r})
sys.argv = ["bench"] + {argv!r}
runpy.run_module("kgat_tpu_torch.bench", run_name="__main__")
"""


def run_cli(argv, cwd):
    return subprocess.run([sys.executable, "-I", "-c",
                           BLOCKED.format(repo=REPO, argv=argv)],
                          capture_output=True, text=True, timeout=240,
                          cwd=cwd, env=torch_threads.one_thread_env())


def test_cli_prints_bench_py_keys(tmp_path):
    """The ref backend, then hopper (plain versions on the CPU) with
    --compare, --serving and two ring/fused partitions; the second run
    loads the graph the first wrote to the default cache dir."""
    common = ["--device", "cpu", "--preset", "smoke", "--iters", "3"]
    outs = []
    for extra in (["--backend", "ref"],
                  ["--compare", "--serving", "--n-devices", "2",
                   "--halo-exchange", "ring", "--ring-transport", "fused"]):
        proc = run_cli(common + extra, tmp_path)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.strip().splitlines()
        assert len(lines) == 1, proc.stdout
        outs.append(json.loads(lines[0]))
        assert "# cf_step" in proc.stderr
    ref, hop = outs
    assert KEYS <= set(ref) and not COMPARE_KEYS & set(ref)
    assert KEYS | COMPARE_KEYS | SERVING_KEYS <= set(hop)
    assert SCALING_KEYS <= set(hop["scaling"])
    assert (ref["backend"], hop["backend"]) == ("ref", "hopper")
    assert (ref["graph_cache_state"], hop["graph_cache_state"]) == (
        "miss", "hit")
    assert ref["vs_baseline"] == 1.0 and hop["plain_versions"]
    assert hop["device"].startswith("cpu:")
    assert hop["scaling"]["n_devices"] == 2
    E = hop["n_edges"]
    scaling = hop["scaling"]
    for out, value in ((ref, ref["value"]), (hop, hop["value"]),
                       (scaling, scaling["cf_step_edges_per_s"])):
        t = out["t_cf_step_ms"] / 1e3     # rounded to 1e-6 s
        assert abs(value - 3 * E / t) <= 3 * E / t * 5e-7 / t + 1
    assert os.path.exists(tmp_path / "runs" / "gcache")


def test_cli_needs_a_card_or_cpu(tmp_path):
    """Without --device cpu the bench needs CUDA: no CPU degrade."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works here")
    proc = run_cli(["--preset", "smoke", "--graph-cache", ""], tmp_path)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""
    proc = run_cli(["--device", "cpu", "--chunk-edges", "512"], tmp_path)
    assert proc.returncode == 2 and "Not to port" in proc.stderr


def test_roofline_keys_at_small_sizes(smoke):
    *_, tg, tmeta, _ = smoke
    out = tbench.roofline(tg, tmeta, seq_shape=(256, 512), mm_n=64, iters=2)
    assert set(out) == {
        "seq_read_gb_s", "gather_gb_s", "tc_bf16_tflops",
        "spmm_fwd_floor_ms", "spmm_fwd_measured_ms", "spmm_coal_floor_ms",
        "spmm_coal_measured_ms", "spmm_efficiency", "spmm_coal_efficiency"}
    for key in ("seq_read_gb_s", "gather_gb_s", "spmm_fwd_measured_ms",
                "spmm_coal_measured_ms", "spmm_efficiency"):
        assert out[key] > 0, key
    assert out["spmm_coal_floor_ms"] <= out["spmm_fwd_floor_ms"]


def test_bench_attention_prints_its_stages(capsys):
    assert bench_attention.main(["--device", "cpu", "--preset", "smoke",
                                 "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for row in ("attention_for_training f32", "attention_for_training bf16",
                "attention+coalesce bf16", "dense logits", "K3 softmax",
                "rev gather f32", "rev gather bf16"):
        assert sum(ln.startswith(row) for ln in lines) == 1, row
    for row in ("att->fwd scatter", "att->fwd gather"):
        assert any(ln.startswith(row) and "absent" in ln for ln in lines)
