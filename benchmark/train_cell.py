"""The training driver: whole trainer epochs, as a user's job runs them.

Set-up builds one ``kgat_tpu_torch.train.Trainer`` from the configuration
and the traffic mix, hands it the benchmark's seeded weights, and drives
its first steps (two CF steps, then two KG steps) through the call the
window makes, ``StepGraph.run``: the first of each kind captures the
step's CUDA graph, the second replays it. Those steps are what the
reference follows once the window has closed. The window then runs whole
``Trainer.train_one_epoch`` calls (a CF phase, a KG phase and an
attention recompute each) and closes at the first epoch boundary at or
after ``--seconds``; ``epoch_s`` is its wall time over its epochs.

With ``--trace 1`` the window's phases are timed (the benchmark wraps
the trainer's ``cf_steps.run`` and ``kg_steps.run`` on the instance and
synchronises inside the wrapper; the phases end in a synchronisation of
their own), and one more epoch runs under ``torch.profiler``.

Under a process group (a traffic mix with ``processes`` > 1, launched by
``launch.py``) every process runs this same code on its own card;
process 0 reports, with the others' device readings gathered to it.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from benchmark import checks, dataset, profiling, reference, weights

# The first steps, which the reference follows.
CHECK_STEPS = ("cf", "cf", "kg", "kg")


def model_config(config: dict):
    """The program's ``KGATConfig`` for the configuration's model."""
    from kgat_tpu_torch.models.kgat import KGATConfig
    mc = config["model"]
    return KGATConfig(
        embed_dim=mc["embed_dim"], relation_dim=mc["relation_dim"],
        conv_dims=tuple(mc["conv_dims"]),
        mess_dropout=tuple(mc["mess_dropout"]),
        aggregator=mc["aggregator"], reg_cf=mc["reg_cf"],
        reg_kg=mc["reg_kg"], ops_backend=mc["ops_backend"],
        compute_dtype=(torch.bfloat16 if mc["compute_dtype"] == "bf16"
                       else None),
        att_impl=mc["att_impl"], coalesce=mc["coalesce"],
        coalesce_cap=mc["coalesce_cap"])


def trainer_config(config: dict, traffic: dict, seed: int, device: str,
                   cache_dir: str):
    """The program's ``TrainConfig`` for this cell: the configuration's
    model and recipe, and the traffic's deployment (its ``trainer`` keys:
    partitions, exchange, transport, dp rows)."""
    from kgat_tpu_torch.utils.config import TrainConfig
    tr = config["train"]
    run = traffic.get("trainer", {})
    return TrainConfig(
        dataset=config["name"], model=model_config(config), lr=tr["lr"],
        cf_batch_size=tr["cf_batch_size"], kg_batch_size=tr["kg_batch_size"],
        seed=weights.derive(seed, 1), sampler=tr["sampler"], device=device,
        log_dir=None, graph_cache=cache_dir, epochs=2 ** 30,
        eval_every=2 ** 30, n_devices=run.get("n_devices", 1),
        halo_exchange=run.get("halo_exchange", "allgather"),
        ring_transport=run.get("ring_transport", "ppermute"),
        dp_replicas=run.get("dp_replicas", 1))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _capturing(dev) -> bool:
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _clone(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(t) for t in x)
    return x.detach().clone()


class FirstSteps:
    """Drives the trainer's first steps through ``StepGraph.run`` and
    keeps what the reference reads: each step's loss and batch (with the
    CF step's dropout masks), the first step's gradient from Adam's state
    after it, and the parameters after the last.

    The batch of a step that runs eagerly (the warm-up before a capture,
    every step on the CPU) is kept by a wrapper of the step's body, which
    records nothing while a capture is recorded; a replayed step's is
    read from the buffers it wrote (``cf_drawn``, ``kg_drawn``)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.dev = trainer.device
        self.losses: List[float] = []
        self.batches: List[tuple] = []
        self.masks: List = []
        self.first_grad = None

    def _body(self, kind, orig, seen):
        def body():
            loss = orig()
            if not _capturing(self.dev):
                seen.append(self._drawn(kind))
            return loss
        return body

    def _drawn(self, kind):
        t = self.trainer
        return _clone(t.cf_drawn if kind == "cf" else t.kg_drawn)

    def run(self) -> None:
        t = self.trainer
        t.stage(t.attention())
        steps = {"cf": t.cf_steps, "kg": t.kg_steps}
        origs = {k: s.body for k, s in steps.items()}
        try:
            for kind in CHECK_STEPS:
                seen = []
                steps[kind].body = self._body(kind, origs[kind], seen)
                part_state = self._part_states() if kind == "cf" else None
                loss = float(steps[kind].run(1))
                drawn = seen[0] if seen else self._drawn(kind)
                self.losses.append(loss)
                if kind == "cf":
                    self.batches.append(tuple(drawn[:4]))
                    self.masks.append(drawn[4] if drawn[4] is not None
                                      else self._part_masks(part_state))
                else:
                    self.batches.append(tuple(drawn))
                    self.masks.append(None)
                if self.first_grad is None:
                    self.first_grad = {
                        n: t.opt.state[p]["exp_avg"].detach().clone()
                        / (1.0 - reference.B1)
                        for n, p in t.model.named_parameters()}
        finally:
            for k, s in steps.items():
                s.body = origs[k]
        _sync(self.dev)
        self.params = {n: p.detach().clone()
                       for n, p in t.model.named_parameters()}

    # The partitioned trainer draws its dropout masks inside the step, from
    # one generator per partition; the benchmark draws them again from the
    # generators' states before the step, in the step's order (layer by
    # layer, partition p's (rows, d_out) block from its own generator), and
    # gathers every partition's block to process 0.
    def _part_states(self):
        t = self.trainer
        if not t.partitioned:
            return None
        return [None if g is None else g.get_state()
                for g in t.part_generators]

    def _part_masks(self, states):
        t = self.trainer
        mc = t.cfg.model
        rows = t.part.info.rows_per_part
        n = t.meta.n_nodes
        own = []
        for st, g in zip(states, t.part_generators):
            if g is None:
                continue
            gen = torch.Generator(device=g.device)
            gen.set_state(st)
            own.append([torch.rand((rows, d), generator=gen,
                                   device=g.device) < 1.0 - rate
                        if rate > 0 else None
                        for d, rate in zip(mc.conv_dims, mc.mess_dropout)])
        masks = []
        for li, rate in enumerate(mc.mess_dropout):
            if rate <= 0:
                masks.append(None)
                continue
            mine = torch.cat([m[li] for m in own]).to(torch.uint8)
            if t.grouped:
                parts = [torch.empty_like(mine) for _ in range(t.n_procs)]
                dist.all_gather(parts, mine)
                mine = torch.cat(parts)
            masks.append(mine[:n].bool())
        return masks


def setup(ctx, stage) -> Dict:
    """Data, trainer, weights and the first steps. ``stage(name)`` marks
    the end of each set-up stage."""
    from kgat_tpu_torch.ops.hopper import build
    from kgat_tpu_torch.train import Trainer
    cfg, traffic = ctx.config, ctx.traffic
    data = dataset.load(cfg["name"], cfg["data"], ctx.cache_dir)
    ds = data.program_dataset()
    stage("data")
    tc = trainer_config(cfg, traffic, ctx.seed, str(ctx.device),
                        ctx.cache_dir)
    trainer = Trainer(tc, dataset=ds)
    stage("trainer")
    if trainer.device.type == "cuda":
        build.library()
    stage("kernels")
    shapes = weights.leaf_shapes(cfg["model"], data.n_nodes,
                                 data.n_relations)
    init = weights.make(ctx.seed, 0, shapes, trainer.device)
    weights.copy_into(trainer.model, init)
    first = FirstSteps(trainer)
    first.run()
    stage("first_steps")
    return {"data": data, "trainer": trainer, "init": init, "first": first}


def _wrap_phase(trainer, spans: Dict, name: str, steps) -> None:
    """``steps.run`` timed on the host, synchronised, and marked for the
    profiler: the instance's attribute shadows the method."""
    orig, dev = steps.run, trainer.device

    def run(n):
        _sync(dev)
        t0 = time.perf_counter()
        with torch.profiler.record_function(profiling.MARK + name):
            out = orig(n)
            _sync(dev)
        rec = spans.setdefault(name, [0.0, 0])
        rec[0] += time.perf_counter() - t0
        rec[1] += n
        return out
    steps.run = run


def _wrap_attention(trainer) -> None:
    orig = trainer.attention

    def attention():
        with torch.profiler.record_function(profiling.MARK + "attention"):
            return orig()
    trainer.attention = attention


def window(ctx, trainer, spans) -> Dict:
    """Whole epochs until the first boundary at or after ``ctx.seconds``."""
    if ctx.trace:
        _wrap_phase(trainer, spans, "cf_phase", trainer.cf_steps)
        _wrap_phase(trainer, spans, "kg_phase", trainer.kg_steps)
        _wrap_attention(trainer)
    _sync(trainer.device)
    if trainer.grouped:
        from kgat_tpu_torch.parallel import multihost
        multihost.barrier(trainer.device)
    ctx.window_open()
    t0 = time.perf_counter()
    epochs = 0
    while True:
        trainer.train_one_epoch()
        epochs += 1
        stop = time.perf_counter() - t0 >= ctx.seconds
        if trainer.grouped:
            # Every process closes the window after the same epoch.
            flag = torch.tensor([float(stop)], device=trainer.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        if stop:
            break
    _sync(trainer.device)
    return {"seconds": time.perf_counter() - t0, "epochs": epochs}


def traced_epoch(trainer) -> Dict:
    """One more epoch under the profiler."""
    _sync(trainer.device)
    with profiling.profile() as prof:
        t0 = time.perf_counter()
        trainer.train_one_epoch()
        _sync(trainer.device)
        wall = time.perf_counter() - t0
    dev = profiling.read(prof)
    dev["window_s"] = wall
    return dev


def reference_graph(data, model_cfg: dict, device) -> reference.Graph:
    src, dst, ety = data.ckg
    return reference.Graph(src, dst, ety, data.n_nodes, data.n_relations,
                           model_cfg["coalesce_cap"], device)


def follow(ctx, data, first: FirstSteps, init, g, prec) -> Dict:
    """The reference over the program's first steps' batches and masks."""
    mc, tr = ctx.config["model"], ctx.config["train"]
    steps = list(zip(CHECK_STEPS, first.batches, first.masks))
    return reference.train_steps(
        init, g, {"n_nodes": data.n_nodes, "n_entities": data.n_entities},
        steps, mc, tr["lr"], prec)


def compare(ctx, data, first: FirstSteps, init, g) -> Dict[str, float]:
    """The program's first steps against the reference, and their batches
    and masks by themselves."""
    ref = follow(ctx, data, first, init, g, ctx.precision)
    prog = {"losses": first.losses, "first_grad": first.first_grad,
            "params": first.params}
    numbers = checks.train_numbers(prog, ref, init)
    cf_m, kg_m = checks.cf_members(data), checks.kg_members(data)
    numbers["bad_rows"] = float(sum(
        checks.bad_cf_rows(data, cf_m, b) if k == "cf"
        else checks.bad_kg_rows(data, kg_m, b)
        for k, b in zip(CHECK_STEPS, first.batches)))
    numbers["mask_z"] = max(
        checks.mask_z(m, ctx.config["model"]["mess_dropout"])
        for k, m in zip(CHECK_STEPS, first.masks) if k == "cf")
    return numbers


def check(ctx, s: Dict) -> Dict[str, float]:
    """The reference over the first steps, after the window."""
    g = reference_graph(s["data"], ctx.config["model"], ctx.device)
    return compare(ctx, s["data"], s["first"], s["init"], g)


def free(s: Dict) -> None:
    """Drops the program's state before the reference runs."""
    t = s.pop("trainer", None)
    if t is not None:
        t.close()
        del t
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> Dict:
    """One run of a training cell; the parts of the result line (process
    0's, with every process's device readings and memory peak)."""
    s = setup(ctx, ctx.stages.mark)
    trainer = s["trainer"]
    spans: Dict = {}
    win = window(ctx, trainer, spans)
    out = {"attempted": win["epochs"], "failed": 0,
           "e2e": {"epoch_s": win["seconds"] / win["epochs"]},
           "window": win, "spans": {k: list(v) for k, v in spans.items()},
           "steps": {"cf": trainer.n_cf_batches, "kg": trainer.n_kg_batches}}
    mine = {"peak": ctx.memory_peak(), "device": None}
    if ctx.trace:
        mine["device"] = traced_epoch(trainer)
        mine["device"]["untraced_s"] = win["seconds"] / win["epochs"]
    every = [mine]
    if trainer.grouped:
        every = [None] * trainer.n_procs
        dist.all_gather_object(every, mine)
    out["memory_peak_bytes"] = max(m["peak"] for m in every)
    if ctx.trace:
        out["devices"] = [m["device"] for m in every]
    del trainer
    free(s)
    if ctx.rank == 0:
        out["numbers"] = check(ctx, s)
        if ctx.trace:
            out["sizes"] = s["data"].sizes
    return out
