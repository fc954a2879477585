"""chip_smoke.py rehearsed on the CPU.

Its phases run only on the GPU machine, where a Python fault would show
for the first time. Here ``run()`` drives phases 3-14 at a tiny size with
the plain versions and a stub timer, in a subprocess where importing jax
or the JAX package raises (the GPU machine has no jax). ``main()`` itself
must refuse to run without CUDA, and the script must fail outside the
repository.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import torch_threads  # one intra-op thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REHEARSAL = """
import sys, tempfile
sys.modules["jax"] = None        # any import of jax raises ImportError
sys.modules["kgat_tpu"] = None
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)         # one intra-op thread: tests/torch_threads.py
import chip_smoke


class StubTimer:
    def sync(self):
        pass

    def device_ms(self, fn, reps):
        fn()
        return 0.0

    def replay_ms(self, fn, reps):
        fn()
        return 0.0

    def host_ms(self, fn, reps):
        fn()
        return 0.0

    def kernel_launches(self, fn):
        fn()
        return None


# 400 nodes: phase 8's four partitions of 128 rows all hold edges.
sizes = chip_smoke.Sizes(
    dataset=dict(n_users=150, n_items=100, n_entities=250, n_relations_kg=4,
                 n_interactions=1500, n_triples=1000),
    hub=300, users=16, steps=3, cf_batch=64, kg_batch=128, chunk=16,
    plateau=dict(users=60, items=40, entities=90, relations=3,
                 interactions=800, triples=400),
    bench_preset="smoke", bench_iters=2,
    roofline=dict(seq_shape=(256, 512), mm_n=64, iters=2))
torch.manual_seed(0)
with tempfile.TemporaryDirectory() as tmp:
    rc = chip_smoke.run(tmp, torch.device("cpu"),
                        torch.Generator().manual_seed(0), "CPU rehearsal",
                        sizes=sizes, timer=StubTimer())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kgat_tpu")
                and sys.modules[m] is not None)
print("RC", rc, leaked)
"""


def test_phases_3_to_7_run_on_the_cpu_without_jax():
    """Phases 3-7, phase 8 (the partitioned trainer), phase 9 (resume,
    pretrain, sparse Adam and the host samplers, eager here) and phase 10
    (a gloo group of one process holding four slots; the cross-process
    paths need two cards), phase 11 (the graph cache, DGL's op surface
    and the explain CLI), phase 12 (the native host loaders against the
    plain ones, a bf16 CLI epoch against a float32 one), phase 13
    (coalescing, its staging and steps, the dense attention route) and
    phase 14 (the port's bench at the smoke preset, its JSON line with
    --compare, its hopper payloads against its ref path's, P = 1 and
    P = 4 ring/fused, the roofline at small probe sizes, a CF step
    against an eager one, the ring/fused engine at P = 1 and 4 against
    the single-device kernel path). Each
    phase prints its wall seconds: a run cut at the time limit shows
    which phase ran long."""
    try:
        proc = subprocess.run([sys.executable, "-I", "-c",
                               REHEARSAL.format(repo=REPO)],
                              capture_output=True, text=True, timeout=240,
                              env=torch_threads.one_thread_env())
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
        pytest.fail(f"the rehearsal ran past 240 s; its output:\n"
                    f"{(out or '')[-3000:]}")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "RC 0 []", lines[-1]
    for n in range(3, 15):
        assert any(ln.startswith(f"[{n}/14] took ") for ln in lines), n
    assert any("need two or more cards" in ln for ln in lines)
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [
        "spmm_csr", "spmm_csr_rev", "sddmm_transr", "segment_softmax_csr",
        "sddmm_transr_bwd", "segment_softmax_csr_bwd", "segment_sum_csr",
        "ring_shift", "reduce_send"]
    for k in kernels:
        assert k["route"] == "cuda"
        assert k["bound_by"] in ("bytes", "operations") and k["bound_ms"] > 0
        assert (k["library_ms"] is None) == (k["name"] in (
            "sddmm_transr", "sddmm_transr_bwd")), k
        assert os.path.exists(os.path.join(REPO, k["source"]))
        path, line = k["replaces"].split(":")
        assert os.path.exists(os.path.join(REPO, path)) and int(line) > 0
        # No kernel launches on the CPU, so none is counted; the plain
        # versions against their float64 references.
        assert k["launches"] == 0 and k["max_abs_err"] <= 1e-5, k
        assert k["cuda_launches_per_call"] is None, k
        # K5 is also timed by CUDA-graph replay (the stub timer's 0.0).
        assert ("replay_ms" in k) == (k["name"] == "segment_softmax_csr_bwd")
        # Phase 11's gspmm calls of K1, counted apart (none on the CPU).
        assert k.get("gspmm_launches", 0) == 0
        assert ("gspmm_launches" in k) == k["name"].startswith("spmm_csr")
        # Phase 13's K1 on the coalesced CSRs, beside the full CSR's.
        assert ("coalesced_ms" in k) == k["name"].startswith("spmm_csr")
        # Phase 14's launches on the bench's path (none on the CPU).
        assert k["bench_launches"] == 0, k
    for what in ("graph cache (--graph-cache)", "DGL op surface",
                 "explain CLI"):
        assert any(ln.startswith(f"[11/14] {what}") for ln in lines), what
    for what in ("host loaders on", "mid-plateau CLI epoch, bf16",
                 "mid-plateau CLI epoch, f32", "bf16 against float32"):
        assert any(ln.startswith(f"[12/14] {what}") for ln in lines), what
    for what in ("coalesced CSRs (cap 8)", "spmm_csr on the coalesced CSRs",
                 "spmm_csr_rev on the coalesced CSRs",
                 "replayed coalesced CF steps", "dense attention route"):
        assert any(ln.startswith(f"[13/14] {what}") for ln in lines), what
    for what in ("bench.run (smoke", "the bench's hopper payloads",
                 "bench_partitioned P = 4 ring/fused",
                 "kernel launches on the bench's path", "bench.roofline",
                 "bench CF step run eagerly",
                 "the bench's ring/fused engine against the single-device"):
        assert any(ln.startswith(f"[14/14] {what}") for ln in lines), what
    bench_line = next(json.loads(ln) for ln in lines
                      if ln.startswith('{"metric": "cf_step_edges_per_s"'))
    assert bench_line["plain_versions"] and "ref_t_cf_step_ms" in bench_line
    assert "FAILED" not in proc.stdout


ACROSS = """
import json, sys, tempfile
sys.modules["jax"] = None
sys.modules["kgat_tpu"] = None
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import chip_smoke
from kgat_tpu_torch.data import load_dataset, save_dataset, synthetic_dataset
sizes = chip_smoke.Sizes(
    dataset=dict(n_users=150, n_items=100, n_entities=250, n_relations_kg=4,
                 n_interactions=1500, n_triples=1000),
    hub=300, users=16, steps=3, cf_batch=64, kg_batch=128, chunk=16)
with tempfile.TemporaryDirectory() as tmp:
    save_dataset(synthetic_dataset(seed=0, name="yelp2018", **sizes.dataset),
                 tmp)
    got = chip_smoke.across_processes(tmp, load_dataset(tmp, "yelp2018"),
                                      sizes, torch.device("cpu"), 2,
                                      "CPU rehearsal")
print("ACROSS " + json.dumps(got))
"""


def test_phase_10_across_processes_runs_on_the_cpu():
    """Phase 10's multi-process part, which the card runs with two or more
    cards, on two CPU processes over gloo at a tiny size: the workers'
    first CF and KG steps against the one-process engine, K7's and K8's
    sends across processes (gloo here) bit-exact, the steps and one CLI
    epoch; no kernel launches on the CPU, so none is counted."""
    try:
        proc = subprocess.run([sys.executable, "-I", "-c",
                               ACROSS.format(repo=REPO)],
                              capture_output=True, text=True, timeout=180,
                              env=torch_threads.one_thread_env())
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else e.stdout
        pytest.fail(f"the rehearsal ran past 180 s; its output:\n"
                    f"{(out or '')[-3000:]}")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(ln.startswith("[10/14] 2 processes, one per card (gloo)")
               for ln in lines), lines
    assert sum("3 rounds bit-exact" in ln for ln in lines) == 2
    assert any("trainer CLI on 2 processes" in ln for ln in lines)
    got = json.loads(lines[-1][len("ACROSS "):])
    for name in ("ring_shift", "reduce_send"):
        assert got[name] == {"process_launches": 0, "process_ms": None}


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        return  # the refusal is for machines without a GPU
    # -E -s, not -I: the script's directory must stay on sys.path.
    proc = subprocess.run([sys.executable, "-E", "-s",
                           os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 2, proc.stderr
    assert "CUDA is not available" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "-E", "-s", "chip_smoke.py"],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_layer_products_hold_the_weight_gradients_terms():
    """chip_smoke's LayerProducts finds every layer product X @ W of the
    plain path and forms |X|^T |dZ|, the term magnitudes each weight's
    gradient sums: no smaller than the gradient anywhere."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from kgat_tpu_torch.data import synthetic_dataset
    from kgat_tpu_torch.models import kgat

    ds = synthetic_dataset(seed=1, n_users=40, n_items=30, n_entities=60,
                           n_relations_kg=3, n_interactions=400,
                           n_triples=200)
    g, meta = ds.build()
    cfg = kgat.KGATConfig(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
                          mess_dropout=(0.0, 0.0))
    model = kgat.init_params(meta.n_nodes, meta.n_relations, cfg,
                             generator=torch.Generator().manual_seed(0))
    params = dict(model.double().named_parameters())
    users = torch.arange(8)
    with chip_smoke.LayerProducts(params) as products:
        loss = kgat.cf_loss(model, g, kgat.attention_for_training(
            model, g, cfg), meta, users, users % 30, (users + 7) % 30, cfg,
            train=False)
    outs = [z for _, _, z in products.found]
    grads = torch.autograd.grad(loss, [*params.values(), *outs],
                                allow_unused=True)
    terms = products.term_magnitudes(grads[len(params):])
    assert [n for n, _, _ in products.found] == [
        "layers.0.w1", "layers.0.w2", "layers.1.w1", "layers.1.w2"]
    assert sorted(terms) == sorted(n for n in params if n.startswith("layers"))
    for name, grad in zip(params, grads):
        if name in terms:
            assert terms[name].shape == grad.shape
            assert (terms[name] >= grad.abs() * (1 - 1e-12)).all(), name
