"""The staged attention weights under ``compute_dtype`` bf16.

``kgat_tpu`` rounds the attention weights it stages for the SpMM to the
value stream's dtype: on one device (``pallas_backend.py:144-145,
:194-195, :455-456``, after the group sum when coalescing) and under
every exchange (``parallel/halo.py:296-297, :312-314``); its kernel then
multiplies bf16 features by bf16 weights. The port's staged weights must
be those numbers: every one a bf16 value, within one bf16 ulp of
``kgat_tpu``'s (the two packages' float32 attention differs in its last
bits, which may tip a rounding). Checked on one device (JAX: the pallas
backend in interpret mode, at its defaults) and with P = 3 partitions
under the all-gather (JAX: pallas, coalesced shards), a2a and the ring
(JAX: the ref backend, as ``tests/test_torch_partition.py``), whose
bucket value stream multiplies in bf16. A bf16 ``propagate`` matches
``kgat_tpu``'s to rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import build_coalesced_layouts, host_array, host_coo
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.parallel import partition as jpart
from kgat_tpu.parallel.dp import make_mesh as j_make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned as j_make_partitioned
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import CKGMeta
from kgat_tpu_torch.models import kgat as tkgat
from kgat_tpu_torch.ops.hopper.segment_sum import bucket_vals
from kgat_tpu_torch.parallel import dp, halo
from kgat_tpu_torch.parallel.partition import (build_ring_buckets,
                                               build_selective_halo,
                                               partition_graph)
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)
MODEL = dict(embed_dim=16, relation_dim=16, conv_dims=(16, 8),
             mess_dropout=(0.0, 0.0))
P = 3


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def assert_bf16_within_one_ulp(got: np.ndarray, want: np.ndarray, what):
    """Every value of ``got`` a bf16 value, and within one bf16 ulp of
    ``want`` (kgat_tpu's bf16 weights)."""
    got = np.asarray(got, np.float32)
    back = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, back, err_msg=f"{what}: not bf16")
    tiny = np.finfo(np.float32).tiny
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), tiny))) - 7)
    assert (np.abs(got - want) <= ulp).all(), what


def _group_positions(gather, n_pairs):
    """Positions of a coalesced layout's groups, in group order, from
    its gather (group id per position; n_pairs and past: dead)."""
    pos = np.nonzero(gather < n_pairs)[0]
    return pos[np.argsort(gather[pos])]


def test_single_device_staged_weights_and_propagate():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, _ = tdata.synthetic_dataset(**SMALL).build()
    jcfg = jkgat.KGATConfig(ops_backend="pallas", compute_dtype=jnp.bfloat16,
                            **MODEL)
    params = jkgat.init_params(jax.random.key(6), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jew = jkgat.attention_for_training(params, jg, jcfg)
        want_emb = np.asarray(jkgat.propagate(params, jg, jew, jcfg))
    assert jew.coalesced and jew.fwd.dtype == jnp.bfloat16
    co = build_coalesced_layouts(jg, jew.cap)
    pos = _group_positions(host_array(co.fwd, "gather"), co.n_pairs)
    want = np.asarray(jew.fwd.astype(jnp.float32))[pos]

    cfg = tkgat.KGATConfig(ops_backend="hopper",
                           compute_dtype=torch.bfloat16, **MODEL)
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ew = tkgat.attention_for_training(model, tg, cfg)
    assert ew.fwd.shape == want.shape
    assert_bf16_within_one_ulp(ew.fwd.numpy(), want, "one device")
    with torch.no_grad():
        got = tkgat.propagate(model, tg, ew, cfg).numpy()
    np.testing.assert_allclose(got, want_emb, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def part():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    coo = host_coo(jg)
    src, dst, ety = coo["src"], coo["dst"], coo["etype"]
    pg, info = jpart.partition_graph(src, dst, ety, jmeta.n_nodes,
                                     jmeta.n_relations, P, chunk_edges=256,
                                     rel_block=256)
    shards, tinfo = partition_graph(src, dst, ety, jmeta.n_nodes,
                                    jmeta.n_relations, P)
    jcfg = jkgat.KGATConfig(compute_dtype=jnp.bfloat16, ops_backend="ref",
                            **MODEL)
    params = jkgat.init_params(jax.random.key(8), jmeta.n_nodes,
                               jmeta.n_relations, jcfg)
    return dict(src=src, dst=dst, jmeta=jmeta, pg=pg, info=info,
                shards=shards, tinfo=tinfo, jcfg=jcfg, params=params,
                meta=CKGMeta(**dataclasses.asdict(jmeta)))


def _canonical(gather, fwd, mask):
    """Shard-canonical weights from an aligned staging: position j holds
    the weight of shard slot gather[j]; slots of pad edges are dropped."""
    out = np.zeros(len(mask), np.float32)
    live = mask[np.minimum(gather, len(mask) - 1)] > 0
    out[gather[live]] = fwd[live]
    return out


@pytest.mark.parametrize("exchange", ["allgather", "a2a", "ring"])
def test_partitioned_staged_weights(part, exchange):
    s = part
    pg, info, params = s["pg"], s["info"], s["params"]
    jcfg = s["jcfg"]
    rb = sel = co = None
    if exchange == "ring":
        rb = jpart.build_ring_buckets(s["src"], s["dst"], info)
    elif exchange == "a2a":
        sel = jpart.build_selective_halo(s["src"], s["dst"], info)
    else:
        jcfg = dataclasses.replace(jcfg, ops_backend="pallas")
        co = jpart.build_coalesced_shards(pg, info)
    pltpu.reset_tpu_interpret_mode_state()
    attention, _, _, _ = j_make_partitioned(
        j_make_mesh(P, axis=AXIS), pg, info, s["jmeta"], jcfg,
        exchange=exchange, ring_buckets=rb, sel_halo=sel, coalesced=co)
    _, jew = attention(pg, params)
    fwd = np.asarray(jew.fwd.astype(jnp.float32))

    cfg = tkgat.KGATConfig(ops_backend="hopper",
                           compute_dtype=torch.bfloat16, **MODEL)
    tpart = halo.Partitioned(
        dp.make_mesh(P, "cpu"), s["shards"], s["tinfo"], s["meta"], cfg,
        exchange=exchange,
        ring_buckets=(build_ring_buckets(s["src"], s["dst"], s["tinfo"])
                      if exchange == "ring" else None),
        halos=(build_selective_halo(s["shards"], s["tinfo"])
               if exchange == "a2a" else None), ring_transport="fused")
    model = tkgat.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    _, staged = tpart.attention(model)
    for p in range(P):
        mask = np.asarray(pg.edge_mask[p])
        w = staged[0][p]
        if exchange == "allgather":
            pos = _group_positions(np.asarray(co.fwd.gather[p]),
                                   w.fwd.shape[0])
            assert_bf16_within_one_ulp(w.fwd.numpy(), fwd[p][pos],
                                       f"allgather partition {p}")
            continue
        if exchange == "a2a":
            want = _canonical(np.asarray(sel.fwd.gather[p]), fwd[p], mask)
            got = w.fwd.numpy()
        else:
            n = s["shards"][p].n_edges
            want = np.zeros(len(mask), np.float32)
            got = np.zeros(n, np.float32)
            for step, b in enumerate(tpart.buckets[0][p]):
                want += _canonical(np.asarray(rb.fwd.gather[p, step]),
                                   fwd[p, step], mask)
                got[b.gather.numpy()] = w[step].fwd.numpy()
                # The ring's value stream multiplies in bf16.
                chunk = torch.randn(s["tinfo"].rows_per_part, 16,
                                    generator=torch.Generator().manual_seed(
                                        step)).to(torch.bfloat16)
                vals = bucket_vals(b, w[step].fwd, chunk)
                assert vals.dtype == torch.bfloat16
                torch.testing.assert_close(
                    vals, (chunk.float()[b.src.long()]
                           * w[step].fwd[:, None]).to(torch.bfloat16),
                    rtol=0, atol=0)
        live = mask > 0
        assert_bf16_within_one_ulp(got, want[live][:len(got)],
                                   f"{exchange} partition {p}")
