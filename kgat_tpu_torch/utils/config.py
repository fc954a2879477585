"""Run configuration: a dataclass, argparse overrides and named presets.

Port of ``kgat_tpu/utils/config.py`` with the same flags. The defaults are
the reference recipe (SURVEY.md §2.9) on one GPU: ``--device cuda
--ops-backend hopper``, with ``kgat_tpu``'s multi-edge coalescing and
attention route (``--no-coalesce``, ``--att-impl``).
On CUDA the device-sampled epoch replays CUDA graphs of its steps
(``train.StepGraph``), the partitioned trainer's too when its partitions
share one card; no flag turns that off.

``--n-devices N`` trains edge-partitioned over N partitions placed
round-robin over the visible GPUs (``parallel/dp.py``); more partitions
than GPUs share a GPU, as ``kgat_tpu``'s tests share virtual CPU devices.
Launched as several processes (COORDINATOR_ADDRESS, NUM_PROCESSES and
PROCESS_ID, as ``kgat_tpu``'s multi-host launch), each owns N / W of
them on its own card (``parallel/multihost.py``).
``--dp-replicas D`` arranges them as a 2D (dp, ep) mesh of D rows of N / D
partitions, and ``--halo-exchange a2a`` exchanges only the rows a peer's
edges read.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from kgat_tpu_torch.models.kgat import KGATConfig


@dataclasses.dataclass
class TrainConfig:
    # data
    dataset: str = "synthetic"          # synthetic | amazon-book | last-fm | yelp2018
    data_root: str = "datasets"
    # model (SURVEY.md §2.9 reference defaults)
    model: KGATConfig = dataclasses.field(
        default_factory=lambda: KGATConfig(ops_backend="hopper"))
    # optimization: one Adam over every parameter, both phases
    lr: float = 1e-4
    cf_batch_size: int = 1024
    kg_batch_size: int = 2048
    epochs: int = 1000
    eval_every: int = 10
    stopping_steps: int = 10            # bad evals on recall@K before stop
    k: int = 20
    ks: tuple = ()                      # extra report-only cutoffs, e.g. (40, 100)
    test_block: int = 2048
    seed: int = 1234
    sampler: str = "device"             # device | host (numpy, per batch)
    sparse_adam: bool = False           # lazy row-sparse Adam, KG phase
    pretrain_path: Optional[str] = None  # BPR-MF npz (--use-pretrain)
    # infra
    device: str = "cuda"                # cuda | cpu (the plain path)
    log_dir: Optional[str] = "runs"
    run_name: str = "kgat"
    ckpt_path: Optional[str] = None     # defaults to <log_dir>/<run_name>_best
    resume: bool = False                # restore the newer of best and last
    profile_epochs: int = 0             # torch.profiler trace of the first N epochs
    graph_cache: Optional[str] = None   # dir for the built-graph npz cache
    # edge partitioning (BASELINE config 5): > 1 partitions the CF phase;
    # 0 = one partition per visible GPU
    n_devices: int = 1
    dp_replicas: int = 1                # >1: 2D (dp, ep) mesh, n_devices
                                        # split into dp_replicas rows
    halo_exchange: str = "allgather"    # allgather | ring | a2a
    ring_transport: str = "ppermute"    # ppermute | dma | fused (ring only)
    # synthetic dataset scale (used when dataset == synthetic)
    syn_users: int = 300
    syn_items: int = 200
    syn_entities: int = 500
    syn_relations: int = 8
    syn_interactions: int = 6000
    syn_triples: int = 4000


# The run configs of kgat_tpu's PRESETS (BASELINE.json), with the pallas
# backend replaced by the Hopper kernels.
PRESETS = {
    # 1: CPU-runnable smoke: 1-layer GCN, small graph
    "smoke-gcn": dict(
        dataset="synthetic", epochs=30, eval_every=5, lr=1e-3,
        cf_batch_size=256, kg_batch_size=512,
        model=KGATConfig(aggregator="gcn", conv_dims=(32,),
                         mess_dropout=(0.1,), ops_backend="hopper"),
    ),
    # 2: reference recipe, 3-layer bi-interaction
    "lastfm-bi": dict(dataset="last-fm",
                      model=KGATConfig(aggregator="bi-interaction",
                                       ops_backend="hopper")),
    # 3: GraphSage ablation on Amazon-book
    "amazon-graphsage": dict(dataset="amazon-book",
                             model=KGATConfig(aggregator="graphsage",
                                              ops_backend="hopper")),
    # 4: Yelp2018 with device-side BPR sampling
    "yelp-device-sampling": dict(dataset="yelp2018",
                                 model=KGATConfig(
                                     aggregator="bi-interaction",
                                     ops_backend="hopper")),
    # 5: edge-partitioned Yelp2018, one partition per visible GPU
    "yelp-partitioned": dict(dataset="yelp2018", n_devices=0,
                             model=KGATConfig(aggregator="bi-interaction",
                                              ops_backend="hopper")),
}


def parse_args(argv=None) -> TrainConfig:
    p = argparse.ArgumentParser(
        description="KGAT trainer (PyTorch, Hopper kernels)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--aggregator", default=None,
                   choices=["gcn", "graphsage", "bi-interaction"])
    p.add_argument("--conv-dims", default=None,
                   help="comma-separated, e.g. 64,32,16")
    p.add_argument("--mess-dropout", default=None, help="comma-separated")
    p.add_argument("--embed-dim", type=int, default=None)
    p.add_argument("--relation-dim", type=int, default=None)
    p.add_argument("--reg-cf", type=float, default=None,
                   help="L2 reg on CF embeddings (reference --regs[0])")
    p.add_argument("--reg-kg", type=float, default=None,
                   help="L2 reg on TransR triples (reference --regs[1])")
    p.add_argument("--ops-backend", default=None,
                   choices=["ref", "hopper", "pallas"],
                   help="hopper (default): the CUDA kernels; ref: plain "
                        "PyTorch; pallas, kgat_tpu's name for its kernel "
                        "backend, is accepted for kgat_tpu's command lines "
                        "and selects hopper")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions)")
    p.add_argument("--att-impl", default=None,
                   choices=["auto", "dense", "relblock"],
                   help="training attention logits route (hopper "
                        "backend): dense per-relation projected tables vs "
                        "the relation-tile SDDMM kernel; auto picks by "
                        "table size")
    p.add_argument("--no-coalesce", action="store_true",
                   help="disable multi-edge coalescing of the training "
                        "SpMM (hopper backend, one device and the "
                        "all-gather's shards)")
    p.add_argument("--compute-dtype", default=None, choices=["f32", "bf16"],
                   help="SpMM value-stream dtype (hopper backend); bf16 "
                        "halves the gathered bytes, accumulation stays f32")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--cf-batch-size", type=int, default=None)
    p.add_argument("--kg-batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--stopping-steps", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--ks", default=None,
                   help="comma-separated extra eval cutoffs; --k stays the "
                        "early-stopping metric")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sampler", default=None, choices=["device", "host"],
                   help="device (default): batches drawn on the device; "
                        "host: kgat_tpu's numpy samplers, one eager step "
                        "per batch")
    p.add_argument("--sparse-adam", action="store_true", default=None,
                   help="lazy row-sparse Adam for the KG phase "
                        "(single device only)")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--run-name", default=None)
    p.add_argument("--resume", action="store_true",
                   help="restore the full state from the newer of the "
                        "best and last checkpoints, and append to the log")
    p.add_argument("--n-devices", type=int, default=None,
                   help="partitions (mesh slots) for edge-partitioned "
                        "training. In one process they are placed "
                        "round-robin over the visible GPUs (several may "
                        "share one); under NUM_PROCESSES > 1 processes, "
                        "process i owns the i-th of equal consecutive "
                        "blocks, all on its card. 0 = one per GPU, or "
                        "one per process; 1 = one device (every process "
                        "trains the same replica)")
    p.add_argument("--dp-replicas", type=int, default=None,
                   help="2D (dp, ep) mesh: the --n-devices partitions as "
                        "this many rows, each holding every shard and "
                        "taking its own block of the CF batch (must divide "
                        "--n-devices)")
    p.add_argument("--halo-exchange", default=None,
                   choices=["allgather", "ring", "a2a"],
                   help="partitioned exchange: per-layer all-gather, the "
                        "ring of bucket reduces, or a2a, the selective "
                        "halo all-to-all of the rows each peer's edges "
                        "read")
    p.add_argument("--ring-transport", default=None,
                   choices=["ppermute", "dma", "fused"],
                   help="ring chunk transport: a plain tensor copy, the "
                        "ring-shift kernel (K7), or the fused reduce + send "
                        "kernel (K8)")
    p.add_argument("--use-pretrain", dest="pretrain_path", default=None,
                   help="BPR-MF npz (user_embed, item_embed) for the "
                        "initial user and item rows "
                        "(python -m kgat_tpu_torch.models.bprmf)")
    p.add_argument("--profile-epochs", type=int, default=None,
                   help="write a torch.profiler trace of the first N "
                        "epochs into --log-dir")
    p.add_argument("--graph-cache", default=None, metavar="DIR",
                   help="directory of the built-graph cache: the graph, "
                        "its row splits and meta are loaded from an npz "
                        "there when the data match, else built and saved")
    for f in ("users", "items", "entities", "relations", "interactions",
              "triples"):
        p.add_argument(f"--syn-{f}", type=int, default=None,
                       help=f"synthetic dataset: number of {f}")
    a = p.parse_args(argv)

    cfg = TrainConfig(**PRESETS[a.preset]) if a.preset else TrainConfig()
    for field in ("dataset", "data_root", "lr", "cf_batch_size",
                  "kg_batch_size", "epochs", "eval_every", "stopping_steps",
                  "k", "seed", "sampler", "sparse_adam", "pretrain_path",
                  "resume", "device", "log_dir", "run_name",
                  "profile_epochs", "graph_cache", "n_devices",
                  "dp_replicas",
                  "halo_exchange",
                  "ring_transport", "syn_users", "syn_items", "syn_entities",
                  "syn_relations", "syn_interactions", "syn_triples"):
        v = getattr(a, field)
        if v is not None:
            setattr(cfg, field, v)
    if a.ks:
        cfg.ks = tuple(int(x) for x in a.ks.split(","))

    m = {}
    if a.aggregator:
        m["aggregator"] = a.aggregator
    if a.conv_dims:
        m["conv_dims"] = tuple(int(x) for x in a.conv_dims.split(","))
    if a.mess_dropout:
        m["mess_dropout"] = tuple(float(x) for x in a.mess_dropout.split(","))
    if a.embed_dim:
        m["embed_dim"] = a.embed_dim
    if a.relation_dim:
        m["relation_dim"] = a.relation_dim
    if a.reg_cf is not None:
        m["reg_cf"] = a.reg_cf
    if a.reg_kg is not None:
        m["reg_kg"] = a.reg_kg
    if a.ops_backend:
        m["ops_backend"] = ("hopper" if a.ops_backend == "pallas"
                            else a.ops_backend)
    if a.att_impl:
        m["att_impl"] = a.att_impl
    if a.no_coalesce:
        m["coalesce"] = False
    if a.compute_dtype:
        m["compute_dtype"] = (torch.bfloat16 if a.compute_dtype == "bf16"
                              else None)
    if m:
        if ("conv_dims" in m) != ("mess_dropout" in m):
            base = m.get("conv_dims", cfg.model.conv_dims)
            m.setdefault("mess_dropout", tuple(0.1 for _ in base))
        cfg.model = dataclasses.replace(cfg.model, **m)
    if cfg.n_devices < 0:
        p.error(f"--n-devices must be >= 0, got {cfg.n_devices}")
    if cfg.dp_replicas < 1:
        p.error(f"--dp-replicas must be >= 1, got {cfg.dp_replicas}")
    if len(cfg.model.conv_dims) != len(cfg.model.mess_dropout):
        p.error(f"--conv-dims has {len(cfg.model.conv_dims)} layers but "
                f"--mess-dropout has {len(cfg.model.mess_dropout)} rates; "
                "they must match")
    return cfg
