"""chip_smoke.py rehearsed on the CPU.

Its phases run only on the GPU machine, where a Python fault would show
for the first time. Here ``run()`` drives phases 3-8 at a tiny size with
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

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REHEARSAL = """
import sys, tempfile
sys.modules["jax"] = None        # any import of jax raises ImportError
sys.modules["kgat_tpu"] = None
sys.path.insert(0, {repo!r})
import torch
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
    hub=300, users=16, steps=3, cf_batch=64, kg_batch=128, chunk=16)
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
    """Phases 3-7, and phase 8 after them (the partitioned trainer)."""
    proc = subprocess.run([sys.executable, "-I", "-c",
                           REHEARSAL.format(repo=REPO)],
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "RC 0 []", lines[-1]
    for n in range(3, 9):
        assert any(ln.startswith(f"[{n}/8]") for ln in lines), n
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
    assert "FAILED" not in proc.stdout


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
