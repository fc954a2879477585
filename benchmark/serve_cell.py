"""The serving driver: requests offered at a fixed rate (an open loop) to
one serving thread that calls ``Recommender.recommend``, with
``refresh()`` to new weights on a fixed period.

The traffic mix's file gives the request sizes (log-uniform over
[min_users, max_users]), how users are drawn (in proportion to their
train interactions: active users ask most), k, and the refresh period.
Set-up builds the request stream (``Requests``: one fixed mix, ordered
by the seed), makes every weight set the window will load, and answers
two requests (the smallest and the largest size). In the window requests
arrive on the stream's schedule (Poisson at ``rate_per_s``) and the
thread answers each in turn (``serve``); a request's latency runs from
its arrival. The window takes the requests that arrive in ``--seconds``;
``serve_users_per_s`` counts the users answered by its close.

A seeded sample of the answered requests, with the longest answered, is
kept and compared with the reference once the window has closed.

With ``--trace 1`` the forward after each refresh runs at once, timed
(``recommend.refresh_ms``), and the stream's first ``trace_s`` seconds
run again, on the same schedule, under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, dataset, profiling, reference, weights
from benchmark.train_cell import _sync, model_config


class Requests:
    """The request stream: a fixed mix of ``pool_requests`` requests,
    drawn once from the mix's own seed (sizes log-uniform over
    [min_users, max_users], users in proportion to their train
    interactions, Poisson arrivals at ``rate_per_s``), which every run
    sends over and over; the run's seed only orders the requests with
    their gaps and deals the users among them. So every seed offers the
    same work at the same rate, in another order. Request i asks for
    ``users(i)`` at ``arrival(i)``."""

    def __init__(self, traffic: dict, activity: np.ndarray, seed: int):
        mix = np.random.default_rng(traffic["mix_seed"])
        lo, hi = traffic["min_users"], traffic["max_users"]
        n_req = traffic["pool_requests"]
        sizes = np.minimum(hi, np.floor(np.exp(mix.uniform(
            math.log(lo), math.log(hi + 1), n_req))).astype(np.int64))
        cdf = np.cumsum(activity, dtype=np.float64)
        cdf /= cdf[-1]
        pool = np.searchsorted(cdf, mix.random(int(sizes.sum())),
                               side="right")
        pool = np.minimum(pool, activity.size - 1)
        # Poisson arrivals at the mix's rate: exponential gaps, scaled so
        # that their mean is exactly 1 / rate.
        gaps = mix.exponential(size=n_req)
        gaps *= n_req / gaps.sum() / traffic["rate_per_s"]
        run = np.random.default_rng([weights.derive(seed, 2), 0])
        order = run.permutation(n_req)
        self.sizes, gaps = sizes[order], gaps[order]
        self.pool = pool[run.permutation(pool.size)]
        self.starts = np.concatenate([[0.0], np.cumsum(gaps)])
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        self.keep = run.random(n_req) < 1.0 / traffic["keep_one_in"]
        self.pick = np.random.default_rng([weights.derive(seed, 3), 0])

    def users(self, i: int) -> np.ndarray:
        j = i % self.sizes.size
        return self.pool[self.offsets[j]:self.offsets[j] + self.sizes[j]]

    def arrival(self, i: int) -> float:
        """Request i's arrival, in seconds from the window's opening."""
        n = self.sizes.size
        return (i // n) * self.starts[n] + self.starts[i % n]

    def kept(self, i: int) -> bool:
        return bool(self.keep[i % self.keep.size])


def setup(ctx, stage) -> Dict:
    from kgat_tpu_torch.models.kgat import KGAT
    from kgat_tpu_torch.ops.hopper import build
    from kgat_tpu_torch.recommend import Recommender, disable_tf32
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    disable_tf32()
    data = dataset.load(cfg["name"], cfg["data"], ctx.cache_dir)
    ds = data.program_dataset()
    stage("data")
    graph, meta = ds.build(cache_dir=ctx.cache_dir)
    graph = graph.to(dev)
    stage("graph")
    if dev.type == "cuda":
        build.library()
    stage("kernels")
    kcfg = model_config(cfg)
    model = KGAT(meta.n_nodes, meta.n_relations, kcfg, device=dev)
    shapes = weights.leaf_shapes(cfg["model"], data.n_nodes,
                                 data.n_relations)
    n_sets = 1 + int(ctx.seconds // traffic["refresh_s"])
    sets = [weights.make(ctx.seed, 100 + i, shapes, dev)
            for i in range(n_sets)]
    weights.copy_into(model, sets[0])
    rec = Recommender(model, graph, meta, kcfg,
                      train_user_dict=ds.train_user_dict)
    reqs = Requests(traffic, data.user_activity(), ctx.seed)
    stage("requests")
    for n in (reqs.sizes.min(), reqs.sizes.max()):
        rec.recommend(reqs.pool[:n], k=traffic["k"])
    stage("warm_up")
    return {"data": data, "rec": rec, "model": model, "sets": sets,
            "reqs": reqs, "graph": graph}


def _wait_until(t: float) -> None:
    """Sleeps, then spins the last fraction of a millisecond, until the
    clock reads ``t``."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 5e-4:
            time.sleep(left - 3e-4)


def serve(ctx, s, seconds: float, spans: Dict, refresh: bool) -> Dict:
    """Requests arrive on the stream's schedule from now for ``seconds``;
    the one serving thread answers them in order, each as soon as it has
    arrived and the one before is answered, and every request that
    arrived in time is answered. A request's latency runs from its
    arrival, so it holds the wait behind earlier ones. With ``refresh``
    the next weight set is loaded every ``refresh_s`` seconds, between
    two requests; under tracing its forward runs at once, timed."""
    rec, model, sets, reqs = s["rec"], s["model"], s["sets"], s["reqs"]
    k, period = ctx.traffic["k"], ctx.traffic["refresh_s"]
    lat: List[float] = []
    late: List[float] = []
    done_users = 0
    kept: Dict[int, tuple] = {}
    longest = (-1, None, None, None)
    loaded, set_of = 0, []
    t0 = time.perf_counter()
    close = t0 + seconds
    i = 0
    while True:
        due = t0 + reqs.arrival(i)
        if due >= close:
            break
        _wait_until(due)
        start = time.perf_counter()
        if refresh and start - t0 >= (loaded + 1) * period \
                and loaded + 1 < len(sets):
            loaded += 1
            weights.copy_into(model, sets[loaded])
            rec.refresh()
            if ctx.trace:
                _sync(ctx.device)
                r0 = time.perf_counter()
                with torch.profiler.record_function(profiling.MARK +
                                                    "refresh"):
                    rec.all_embed
                    _sync(ctx.device)
                span = spans.setdefault("refresh", [0.0, 0])
                span[0] += time.perf_counter() - r0
                span[1] += 1
        users = reqs.users(i)
        with (torch.profiler.record_function(profiling.MARK + "request")
              if ctx.trace else contextlib.nullcontext()):
            items, scores = rec.recommend(users, k=k)
        done = time.perf_counter()
        lat.append(done - due)
        late.append(start - due)
        if done <= close:
            done_users += users.size
        set_of.append(loaded)
        if reqs.kept(i):
            kept[i] = (items, scores)
        if users.size > longest[0]:
            longest = (users.size, i, items, scores)
        i += 1
    wall = time.perf_counter() - t0
    if longest[1] not in kept:
        kept[longest[1]] = (longest[2], longest[3])
    return {"seconds": seconds, "wall": wall, "requests": i,
            "done_users": done_users, "latencies": lat, "late": late,
            "kept": kept, "set_of": set_of, "longest": longest[1]}


def window(ctx, s, spans) -> Dict:
    _sync(ctx.device)
    ctx.window_open()
    return serve(ctx, s, ctx.seconds, spans, refresh=True)


def traced_requests(ctx, s) -> Dict:
    """The stream's first ``trace_s`` seconds again, on the same
    schedule, under the profiler."""
    _sync(ctx.device)
    with profiling.profile() as prof:
        t0 = time.perf_counter()
        serve(ctx, s, ctx.traffic["trace_s"], {}, refresh=False)
        _sync(ctx.device)
        wall = time.perf_counter() - t0
    dev = profiling.read(prof)
    dev["window_s"] = wall
    return dev


def check(ctx, s, win) -> Dict[str, float]:
    """A seeded sample of the kept requests, with the longest, against the
    reference's masked top k under the weights each was served with."""
    data, reqs, sets = s["data"], s["reqs"], s["sets"]
    mc, dev = ctx.config["model"], ctx.device
    kept = sorted(win["kept"])
    n_check = min(len(kept), ctx.traffic["check_requests"])
    pick = set(reqs.pick.choice(kept, size=n_check, replace=False).tolist())
    pick.add(win["longest"])
    src, dst, ety = data.ckg
    g = reference.Graph(src, dst, ety, data.n_nodes, data.n_relations,
                        mc["coalesce_cap"], dev)
    ptr, items = data.train_items
    ptr_t = torch.as_tensor(ptr, device=dev)
    items_t = torch.as_tensor(items, device=dev)
    worst: Dict[str, float] = {}
    for w in sorted({win["set_of"][i] for i in pick}):
        emb = reference.serve_embed(sets[w], g, mc, ctx.precision)
        for i in sorted(pick):
            if win["set_of"][i] != w:
                continue
            users = torch.as_tensor(reqs.users(i), device=dev)
            ref = reference.scores(emb, users, data.n_entities, data.n_items,
                                   ptr_t, items_t, ctx.precision)
            got_items, got_scores = win["kept"][i]
            for key, v in checks.serve_numbers(got_items, got_scores,
                                               ref).items():
                worst[key] = max(worst.get(key, 0.0), v)
        del emb
    worst["checked_users"] = float(sum(reqs.users(i).size for i in pick))
    return worst


def free(s) -> None:
    for key in ("rec", "model", "graph"):
        s.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> Dict:
    s = setup(ctx, ctx.stages.mark)
    spans: Dict = {}
    win = window(ctx, s, spans)
    lat = np.asarray(win["latencies"])
    late = np.asarray(win["late"])
    out = {"attempted": win["requests"], "failed": 0,
           "e2e": {"serve_users_per_s": win["done_users"] / win["seconds"],
                   "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3},
           "window": {"seconds": win["seconds"], "wall": win["wall"],
                      "requests": win["requests"],
                      "done_users": win["done_users"],
                      "start_late_p95_ms": float(np.percentile(late, 95))
                      * 1e3,
                      "start_late_max_ms": float(late.max()) * 1e3},
           "spans": spans}
    if ctx.trace:
        out["devices"] = [traced_requests(ctx, s)]
    out["memory_peak_bytes"] = ctx.memory_peak()
    free(s)
    numbers = check(ctx, s, win)
    out["checked_users"] = numbers.pop("checked_users")
    out["numbers"] = numbers
    return out
