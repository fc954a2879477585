"""One process of a multi-process run of the port's partitioned trainer
machinery, over gloo on the CPU (``tests/test_torch_multihost.py``).

    python torch_mp_worker.py <init_url> <n_procs> <pid> <setup.npz> <out_dir>

Forms the process group (``multihost.initialize_distributed`` on the CPU,
``init_url`` a ``file://`` rendezvous), checks that a second call with
the same spec returns the rank and one with another spec raises, and
that ``KGAT_DP_CHECK_BATCH=1`` passes a batch every process drew alike
and refuses one that differs by rank, then:

* the differentiable collectives on inputs drawn from numpy seeded by the
  rank (all-gather, all-to-all, the ring's send/receive), forward and
  backward, written to ``coll<pid>.npz``;
* for each mesh of ``CASES`` (P = 4 partitions in all, one per process),
  with dropout 0 and 0.5: the attention of this process's partitions,
  the eval-mode forward (dropout 0), and the first CF step on the given
  batch: the loss and gradients summed over the processes
  (``multihost.GradSum``) and the entity table after one Adam step,
  dropout drawn from slot i's generator seeded ``SEED + 1 + i``;
* one data-parallel KG step (``dp.kg_block_loss`` on this process's block
  of the batch).

Each result goes to ``<out_dir>/<case>.<pid>.npz`` and a ``RESULT`` line.
The graph's edges, the weights and the batches come from ``setup.npz``,
written by the test. Imports neither jax nor kgat_tpu.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kgat_tpu_torch.graph import CKGMeta  # noqa: E402
from kgat_tpu_torch.models import kgat  # noqa: E402
from kgat_tpu_torch.models.kgat import KGATConfig  # noqa: E402
from kgat_tpu_torch.optim import make_optimizer  # noqa: E402
from kgat_tpu_torch.parallel import dp, halo, multihost  # noqa: E402
from kgat_tpu_torch.parallel.partition import (  # noqa: E402
    build_ring_buckets, build_selective_halo, partition_graph)
from kgat_tpu_torch.utils.checkpoint import _unflatten  # noqa: E402

torch.set_num_threads(1)

MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8))
P = 4
SEED = 3
LR = 1e-3
# (exchange, transport, dp rows)
CASES = (("allgather", "ppermute", 1), ("ring", "ppermute", 1),
         ("ring", "dma", 1), ("ring", "fused", 1), ("a2a", "ppermute", 1),
         ("ring", "fused", 2))
META = ("n_users", "n_entities", "n_items", "n_relations_kg", "n_relations",
        "rel_interact", "rel_interacted_by")


def label(exchange, transport, rows, dropout):
    return f"{exchange}-{transport}-{rows}-{dropout}"


def collectives(pid, n, out_dir):
    """Each collective on rank-seeded inputs; the loss on each rank is
    sum(output * g) with g drawn from the same seed."""
    rs = np.random.default_rng(100 + pid)
    t = lambda *shape: torch.tensor(rs.standard_normal(shape),  # noqa: E731
                                    requires_grad=True)
    out = {}
    x = t(3, 2)
    y = multihost.all_gather(x, None)
    (y * torch.tensor(rs.standard_normal(y.shape))).sum().backward()
    out.update(gather=y.detach().numpy(), gather_grad=x.grad.numpy())
    x = t(2 * n, 3)
    y = multihost.all_to_all(x, None)
    (y * torch.tensor(rs.standard_normal(y.shape))).sum().backward()
    out.update(a2a=y.detach().numpy(), a2a_grad=x.grad.numpy())
    x = t(2, 3)
    y = multihost.shift(x, (pid + 1) % n, (pid - 1) % n)
    (y * torch.tensor(rs.standard_normal(y.shape))).sum().backward()
    out.update(shift=y.detach().numpy(), shift_grad=x.grad.numpy())
    np.savez(os.path.join(out_dir, f"coll.{pid}.npz"), **out)


def main():
    url, n, pid, setup, out_dir = sys.argv[1:6]
    n, pid = int(n), int(pid)
    assert multihost.initialize_distributed(url, n, pid, "cpu") == pid
    try:
        assert multihost.initialize_distributed(url, n, pid, "cpu") == pid
        try:
            multihost.initialize_distributed(url + ".other", n, pid, "cpu")
        except RuntimeError as e:
            assert "conflicting group specs" in str(e), e
        else:
            raise AssertionError("a conflicting spec was accepted")
        # KGAT_DP_CHECK_BATCH: the same batch passes, a diverged one raises.
        os.environ["KGAT_DP_CHECK_BATCH"] = "1"
        dp.check_batch([torch.arange(6.0)])
        try:
            dp.check_batch([torch.tensor([float(pid)])])
        except AssertionError as e:
            diverged = "batches diverged" in str(e)
        else:
            diverged = False
        del os.environ["KGAT_DP_CHECK_BATCH"]
        print(f"RESULT case=group pid={pid} rank={dist.get_rank()} "
              f"world={dist.get_world_size()} "
              f"slots={multihost.local_shard_ids(P)} diverged={diverged}",
              flush=True)
        collectives(pid, n, out_dir)
        run(pid, setup, out_dir)
    finally:
        dist.destroy_process_group()


def run(pid, setup, out_dir):
    with np.load(setup) as z:
        arrays = {k: z[k] for k in z.files}
    meta = CKGMeta(**{k: int(arrays[k]) for k in META})
    params = _unflatten(arrays, "p")
    t = lambda k: torch.from_numpy(arrays[k])  # noqa: E731
    u, ip, ineg, w = t("u").long(), t("ip").long(), t("ineg").long(), t("w")
    layouts = {}
    for parts in (P, P // 2):
        shards, info = partition_graph(arrays["src"], arrays["dst"],
                                       arrays["ety"], meta.n_nodes,
                                       meta.n_relations, parts)
        layouts[parts] = (shards, info,
                          build_ring_buckets(arrays["src"], arrays["dst"],
                                             info),
                          build_selective_halo(shards, info))
    for exchange, transport, rows in CASES:
        shards, info, buckets, halos = layouts[P // rows]
        mesh = dp.make_mesh(P // rows, "cpu", rows)
        for dropout in (0.0, 0.5):
            cfg = KGATConfig(ops_backend="hopper",
                             mess_dropout=(dropout,) * 2, **MODEL)
            part = halo.Partitioned(
                mesh, shards, info, meta, cfg, exchange=exchange,
                ring_buckets=buckets if exchange == "ring" else None,
                halos=halos if exchange == "a2a" else None,
                ring_transport=transport)
            model = kgat.params_from_jax(params, cfg)
            atts, staged = part.attention(model)
            out = {f"att{p}": a.numpy() for p, a in enumerate(atts)
                   if a is not None}
            if dropout == 0:
                out["all_embed"] = part.propagate_eval(model, staged).numpy()
            opt = make_optimizer(model.parameters(), LR)
            grad_sum = multihost.GradSum(model.parameters(), "cpu")
            opt.zero_grad(set_to_none=False)
            gens = [None if dv is None
                    else torch.Generator().manual_seed(SEED + 1 + i)
                    for i, dv in enumerate(mesh.devices)]
            loss = part.cf_loss(model, staged, u, ip, ineg, weight=w,
                                generators=gens)
            loss.backward()
            total = grad_sum(loss)
            out.update({f"grad/{k}": p.grad.numpy().copy()
                        for k, p in model.named_parameters()})
            opt.step()
            out.update(loss=total.numpy(), part_loss=loss.detach().numpy(),
                       entity=model.entity_embed.detach().numpy())
            name = label(exchange, transport, rows, dropout)
            np.savez(os.path.join(out_dir, f"{name}.{pid}.npz"), **out)
            print(f"RESULT case={name} pid={pid} cf={float(total):.8f} "
                  f"slots={list(mesh.local_slots())}", flush=True)

    # The data-parallel KG step: this process's block of the batch.
    cfg = KGATConfig(ops_backend="hopper", **MODEL)
    model = kgat.params_from_jax(params, cfg)
    opt = make_optimizer(model.parameters(), LR)
    grad_sum = multihost.GradSum(model.parameters(), "cpu")
    opt.zero_grad(set_to_none=False)
    h, r, tp, tn = (t(k).long() for k in ("h", "r", "tp", "tn"))
    b = h.shape[0] // dist.get_world_size()
    loss = dp.kg_block_loss(model, h, r, tp, tn, cfg, t("kw"),
                            slice(pid * b, (pid + 1) * b))
    loss.backward()
    total = grad_sum(loss)
    out = {f"grad/{k}": p.grad.numpy().copy()
           for k, p in model.named_parameters()}
    opt.step()
    out.update(loss=total.numpy(), entity=model.entity_embed.detach().numpy())
    np.savez(os.path.join(out_dir, f"kg.{pid}.npz"), **out)
    print(f"RESULT case=kg pid={pid} kg={float(total):.8f}", flush=True)


if __name__ == "__main__":
    main()
