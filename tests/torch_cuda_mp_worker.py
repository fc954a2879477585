"""One process of a multi-process run on the card (``tests/test_torch_cuda.
py``, marker ``cuda``): one of W processes, rank ``pid``.

    python torch_cuda_mp_worker.py ring <init_url> <W> <pid> <out_dir>
    python torch_cuda_mp_worker.py timeout <init_url> <W> <pid> <out_dir>
    python torch_cuda_mp_worker.py steps <init_url> <W> <pid> <out_dir>
    python torch_cuda_mp_worker.py refuse <init_url> <W> <pid> <out_dir>

``ring``: a gloo group (the processes may share a card: no NCCL), and a
``ProcessRing`` on ``cuda:(pid % device_count)``: K7 and K8 store into
the next process's registered buffer (and K7 into the previous one's),
30 times eagerly and 30 times replayed from a CUDA graph, each on new
data; every received chunk must equal, bit for bit, the chunk the
neighbour drew (from a generator seeded by its rank and the round), and
K8's sums ``ref.segment_sum_csr``'s within the float32 summation bound.
Then the link is closed and a second one registered, as a second
trainer in the same processes would, and the rounds run again on it.

``timeout``: a gloo group of two processes, a ``ProcessRing`` with a
2-second wait; process 1 never sends, so process 0's wait for its store
must fail its CUDA context, and its next synchronisation raise.

``steps``: an NCCL group, one process per card, and for each mesh of
``MESHES`` in turn (named as ``mesh_name`` gives it) the partitioned
trainer (P = W, dropout 0), each closed before the next: its first CF
step on a fixed batch and a KG step (losses and gradients, summed over
the processes) written to ``<out_dir>/<mesh>.<pid>.npz``; then its steps
captured (the NCCL calls, and K7 / K8 across processes, inside the
graphs), 20 replays of each against 20 eager steps from the same state.

``refuse``: more processes than cards on NCCL: ``initialize_distributed``
must refuse two ranks on one card before NCCL fails.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kgat_tpu_torch import train  # noqa: E402
from kgat_tpu_torch.models import kgat  # noqa: E402
from kgat_tpu_torch.ops import ref  # noqa: E402
from kgat_tpu_torch.ops.hopper import remote_ring  # noqa: E402
from kgat_tpu_torch.ops.row_split import build_row_split  # noqa: E402
from kgat_tpu_torch.parallel import multihost  # noqa: E402
from kgat_tpu_torch.recommend import disable_tf32  # noqa: E402
from kgat_tpu_torch.utils.config import TrainConfig  # noqa: E402

MESHES = (dict(halo_exchange="allgather"),
          dict(halo_exchange="ring", ring_transport="ppermute"),
          dict(halo_exchange="ring", ring_transport="dma"),
          dict(halo_exchange="ring", ring_transport="fused"),
          dict(halo_exchange="a2a"))
ROUNDS = 30
R, D = 1000, 48


def mesh_name(mesh) -> str:
    return "-".join(mesh.values())


def trainer_cfg(**kw) -> TrainConfig:
    """tests/test_torch_cuda.py's small trainer, dropout 0."""
    return TrainConfig(**{
        **dict(dataset="synthetic", device="cuda", log_dir=None, seed=3,
               cf_batch_size=128, kg_batch_size=256, syn_users=300,
               syn_items=200, syn_entities=500, syn_relations=6,
               syn_interactions=6000, syn_triples=4000,
               model=kgat.KGATConfig(embed_dim=32, relation_dim=32,
                                     conv_dims=(32, 16),
                                     mess_dropout=(0.0, 0.0),
                                     ops_backend="hopper")), **kw})


def chunk(rank: int, rnd: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(10000 * rank + rnd)
    return torch.randn(R, D, generator=g).to(dev)


def ring_mode(url, world, pid, out_dir):
    multihost.form_group(url, world, pid, "cpu")
    dev = torch.device("cuda", pid % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    prev, nxt = (pid - 1) % world, (pid + 1) % world
    keys = {(0, s, dirn): ((R, D), torch.float32)
            for s in range(2) for dirn in (1, -1)}
    rs = np.random.default_rng(7)
    deg = rs.integers(0, 9, R)
    deg[5] = 3000                                   # a long row
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(
        np.int32)).to(dev)
    split = build_row_split(ro)
    vals = torch.from_numpy(rs.standard_normal((int(deg.sum()), D)).astype(
        np.float32)).to(dev)
    want_sums = ref.segment_sum_csr(ro, vals.double())
    bound = (ro[1:] - ro[:-1]).double()[:, None] * 2.0 ** -23 * \
        ref.segment_sum_csr(ro, vals.double().abs())

    def check(rnd, got_fwd, got_bwd, got8, sums):
        torch.cuda.synchronize(dev)
        assert torch.equal(got_fwd.cpu(), chunk(prev, rnd, "cpu")), rnd
        assert torch.equal(got_bwd.cpu(), chunk(nxt, rnd + 500, "cpu")), rnd
        assert torch.equal(got8.cpu(), chunk(prev, rnd + 900, "cpu")), rnd
        assert bool(((sums.double() - want_sums).abs() <= bound).all()), rnd

    # Two links in turn, the first closed before the second registers.
    for link in range(2):
        ring = remote_ring.ProcessRing(None, prev, nxt, dev, keys)
        first = 2 * ROUNDS * link
        for rnd in range(first, first + ROUNDS):
            got_fwd = ring.shift((0, 0, 1), chunk(pid, rnd, dev))
            got_bwd = ring.shift((0, 0, -1), chunk(pid, rnd + 500, dev))
            sums, got8 = ring.reduce_send((0, 1, 1), ro, vals, split,
                                          chunk(pid, rnd + 900, dev))
            check(rnd, got_fwd, got_bwd, got8, sums)
            dist.barrier()   # every read of this round before the next stores
        # The same sends captured once and replayed on new data.
        srcs = [torch.empty(R, D, device=dev) for _ in range(3)]
        outs = [torch.empty(R, D, device=dev) for _ in range(4)]
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(graph):
            outs[0].copy_(ring.shift((0, 0, 1), srcs[0]))
            outs[1].copy_(ring.shift((0, 0, -1), srcs[1]))
            s, r8 = ring.reduce_send((0, 1, 1), ro, vals, split, srcs[2])
            outs[2].copy_(r8)
            outs[3].copy_(s)
        for rnd in range(first + ROUNDS, first + 2 * ROUNDS):
            for src, off in zip(srcs, (0, 500, 900)):
                src.copy_(chunk(pid, rnd + off, dev))
            graph.replay()
            check(rnd, outs[0], outs[1], outs[2], outs[3])
            dist.barrier()
        del graph
        ring.close()
    print(f"RESULT mode=ring pid={pid} device={dev} rounds={4 * ROUNDS} "
          f"process_launches={dict(remote_ring.process_launches)}",
          flush=True)


def timeout_mode(url, world, pid, out_dir):
    multihost.form_group(url, world, pid, "cpu")
    dev = torch.device("cuda", pid % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    ring = remote_ring.ProcessRing(None, (pid - 1) % world, (pid + 1) % world,
                                   dev, {(0, 0, 1): ((R, D), torch.float32)},
                                   timeout_s=2.0)
    if pid == 0:
        t0 = time.perf_counter()
        try:
            ring.shift((0, 0, 1), chunk(pid, 0, dev))
            torch.cuda.synchronize(dev)
            error = None
        except RuntimeError as e:
            error = str(e).splitlines()[0]
        print(f"RESULT mode=timeout pid=0 after={time.perf_counter() - t0:.1f}"
              f" error={error!r}", flush=True)
    dist.barrier()


def steps_mode(url, world, pid, out_dir):
    assert multihost.initialize_distributed(url, world, pid, "cuda") == pid
    disable_tf32()
    for mesh in MESHES:
        name = mesh_name(mesh)
        tr = train.Trainer(trainer_cfg(n_devices=world, **mesh))
        assert tr.sync and tr.captured, tr.capture_why
        users = torch.arange(128, device=tr.device) % tr.meta.n_users
        batch = (users, users % tr.meta.n_items,
                 (users + 7) % tr.meta.n_items)
        out = {"cf_loss": float(tr.cf_grad(tr.attention(), *batch))}
        out.update({f"cf/{k}": p.grad.cpu().numpy()
                    for k, p in tr.model.named_parameters()})
        kg = tr.sample_kg()
        out["kg_loss"] = float(tr.kg_grad(*kg))
        out.update({f"kg/{k}": p.grad.cpu().numpy()
                    for k, p in tr.model.named_parameters()})
        out.update({f"kg_batch/{i}": t.cpu().numpy()
                    for i, t in enumerate(kg)})
        # 20 replays of each step against 20 eager steps from one state.
        tr.stage(tr.attention())
        tr.cf_steps.capture()
        tr.kg_steps.capture()
        params = [p.detach().clone() for p in tr.model.parameters()]
        state = {p: {k: v.clone() for k, v in s.items()}
                 for p, s in tr.opt.state.items()}
        gens = [g.get_state() for g in tr.cf_steps.generators]
        replayed = (float(tr.cf_steps.run(20)), float(tr.kg_steps.run(20)))
        with torch.no_grad():
            for p, v in zip(tr.model.parameters(), params):
                p.copy_(v)
            for p, s in state.items():
                for k, v in s.items():
                    tr.opt.state[p][k].copy_(v)
        for g, s in zip(tr.cf_steps.generators, gens):
            g.set_state(s)
        eager = [torch.zeros((), device=tr.device) for _ in range(2)]
        for _ in range(20):
            eager[0] += tr._cf_body()
        for _ in range(20):
            eager[1] += tr._kg_body()
        out["replayed"] = np.array(replayed)
        out["eager"] = np.array([float(e) for e in eager])
        np.savez(os.path.join(out_dir, f"{name}.{pid}.npz"), **out)
        print(f"RESULT mode=steps pid={pid} mesh={name} "
              f"cf={out['cf_loss']:.6f} kg={out['kg_loss']:.6f} "
              f"replayed={replayed} eager={out['eager'].tolist()} "
              f"why={tr.capture_why!r}", flush=True)
        tr.close()
        del tr
        torch.cuda.empty_cache()


def refuse_mode(url, world, pid, out_dir):
    try:
        multihost.initialize_distributed(url, world, pid, "cuda")
    except RuntimeError as e:
        print(f"RESULT mode=refuse pid={pid} refused={str(e)!r}", flush=True)
        return
    print(f"RESULT mode=refuse pid={pid} formed rank {dist.get_rank()}",
          flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, url, world, pid, out_dir = sys.argv[1:6]
    {"ring": ring_mode, "timeout": timeout_mode, "steps": steps_mode,
     "refuse": refuse_mode}[mode](
        url, int(world), int(pid), out_dir, *sys.argv[6:])
    if dist.is_initialized():
        dist.destroy_process_group()
