"""K3, K5 and K4's fold on the row split, emulated on the CPU.

On the card, K3 (``csrc/softmax.cu``) walks the CSR's work units
(``ops/row_split.py``): a whole row's unit writes its weights, a split
row's units write (max, sum) partials that a second launch combines in
slot order. ``ref.split_segment_softmax`` repeats that arithmetic; here it
is held against ``kgat_tpu``'s segment softmax kernel
(``segment_softmax_aligned``, interpret mode) and ``ref.segment_softmax_coo``
on rows at the chunk boundaries, a hub, rows of equal logits, rows of
+-1e30 and empty rows, at rtol 1e-5 and atol 1e-7 (the sums take another
order than the Pallas kernel's). K5, its backward, walks the same units
(a split row's units write sums of w g); ``ref.split_segment_softmax_bwd``
is held against ``segment_softmax_aligned_bwd`` and
``ref.segment_softmax_coo_bwd`` on the same rows and at the same
tolerance.

K4's fold sums each node's d_eh rows over the forward CSR's units and its
d_et rows, gathered through ``rev_perm``, over the reverse CSR's
(``ref.split_segment_sum`` twice). With the rows of K4's emulated tile
kernel (``ref.transr_bwd_tiles``, three TF32 passes) it is held against
``jax.vjp`` of ``kgat_tpu``'s attention logits, as
``tests/test_torch_grads.py`` holds K4's plain version: rtol 1e-4, atol
1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu import data as jdata
from kgat_tpu.graph import build_graph as jax_build_graph
from kgat_tpu.graph import host_array
from kgat_tpu.models import kgat as jkgat
from kgat_tpu.ops.pallas.softmax import (segment_softmax_aligned,
                                         segment_softmax_aligned_bwd)
from kgat_tpu_torch import data as tdata
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.row_split import CHUNK, build_row_split
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

SMALL = dict(seed=11, n_users=60, n_items=40, n_entities=90,
             n_relations_kg=4, n_interactions=700, n_triples=500)


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _softmax_rows(chunk):
    """Row lengths and logits: the chunk-boundary rows of
    tests/test_torch_row_split.py, a hub of 3,000, two rows of equal
    logits (one split), a row of +-1e30 beside ordinary logits (split),
    a row of -1e30 alone, and empty rows."""
    c = chunk
    lens = [0, 1, c - 1, c, c + 1, 0, 3 * c + 5, 2, 20 * c + 3, 0, 3000,
            c + 1, 7, 2 * c + 1, 3, 0]
    rs = np.random.default_rng(c)
    logits = [(3 * rs.normal(size=n)).astype(np.float32) for n in lens]
    logits[11][:] = 0.7
    logits[12][:] = -2.5
    logits[13][::3] = 1e30
    logits[13][1::3] = -1e30
    logits[14][:] = -1e30
    return np.array(lens), np.concatenate(logits)


class _Rows:
    """:func:`_softmax_rows` as a CSR on both sides: the port's graph and
    its row split of ``chunk`` edges, and ``kgat_tpu``'s forward layout,
    with the maps between canonical and aligned edge order."""

    def __init__(self, chunk):
        self.lens, self.logits = _softmax_rows(chunk)
        n = len(self.lens)
        dst = np.repeat(np.arange(n), self.lens)
        src = np.random.default_rng(0).integers(0, n, len(dst))
        ety = np.zeros(len(dst), np.int64)
        self.tg = build_graph(src, dst, ety, n_nodes=n, n_relations=1)
        self.split = build_row_split(self.tg.row_offsets, chunk)
        assert self.split.n_split > 0
        self.lay = jax_build_graph(src, dst, ety, n, 1).fwd_layout
        self.gather = host_array(self.lay, "gather")
        self.real = self.gather < len(dst)

    def aligned(self, x):
        """Canonical (E,) -> the layout's aligned order, dead slots 0."""
        out = np.zeros(len(self.gather), np.float32)
        out[self.real] = x[self.gather[self.real]]
        return jnp.asarray(out)

    def canonical(self, x_al):
        out = np.zeros(len(self.logits), np.float32)
        out[self.gather[self.real]] = np.asarray(x_al)[self.real]
        return out


@pytest.mark.parametrize("chunk", [1, 3, CHUNK])
def test_split_softmax_matches_pallas_and_plain(chunk):
    c = _Rows(chunk)
    lens, logits, tg, n = c.lens, c.logits, c.tg, len(c.lens)
    got = ref.split_segment_softmax(c.split, torch.from_numpy(logits)).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = c.canonical(segment_softmax_aligned(c.aligned(logits), c.lay))
    plain = ref.segment_softmax_coo(tg.dst, torch.from_numpy(logits),
                                    n).numpy()

    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-7)
    ro = tg.row_offsets.numpy()
    row = lambda i: got[ro[i]:ro[i + 1]]  # noqa: E731
    assert row(1)[0] == 1.0                                   # one edge
    np.testing.assert_allclose(row(11), 1 / lens[11], rtol=1e-6)  # equal
    # +-1e30: the +1e30 entries share the row, the rest get 0.
    big = row(13)[::3]
    np.testing.assert_allclose(big, 1 / len(big), rtol=1e-6)
    assert not row(13)[1::3].any() and not row(13)[2::3].any()
    np.testing.assert_allclose(row(14), 1 / 3, rtol=1e-6)
    sums = np.add.reduceat(got, ro[:-1][lens > 0])
    np.testing.assert_allclose(sums, 1.0, rtol=1e-5)


@pytest.mark.parametrize("chunk", [1, 3, CHUNK])
def test_split_softmax_bwd_matches_pallas_and_plain(chunk):
    """K5's unit arithmetic (``ref.split_segment_softmax_bwd``: unit sums
    of w g, a split row's slots summed in slot order, then w (g - s))
    against ``kgat_tpu``'s ``segment_softmax_aligned_bwd`` (interpret
    mode) and ``ref.segment_softmax_coo_bwd``, on the weights of the
    Pallas forward, so that all three see the same w."""
    c = _Rows(chunk)
    g = np.random.default_rng(chunk + 1).normal(
        size=len(c.logits)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        w_al = segment_softmax_aligned(c.aligned(c.logits), c.lay)
        want = c.canonical(segment_softmax_aligned_bwd(w_al, c.aligned(g),
                                                       c.lay))
    w, gt = torch.from_numpy(c.canonical(w_al)), torch.from_numpy(g)
    got = ref.split_segment_softmax_bwd(c.split, w, gt).numpy()
    plain = ref.segment_softmax_coo_bwd(c.tg.dst, w, gt,
                                        len(c.lens)).numpy()

    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-7)
    ro = c.tg.row_offsets.numpy()
    assert got[ro[1]] == 0.0                  # one edge: w = 1, g - s = 0
    # +-1e30: the edges of weight 0 get 0.
    assert not got[ro[13]:ro[14]][1::3].any()


def test_split_softmax_bwd_is_the_plain_backward_in_float64():
    """In float64 K5's unit arithmetic equals the plain backward up to
    float64 roundings."""
    lens, logits = _softmax_rows(4)
    dst = torch.from_numpy(np.repeat(np.arange(len(lens)), lens))
    ro = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    w = ref.segment_softmax_coo(dst, torch.from_numpy(logits).double(),
                                len(lens))
    g = torch.from_numpy(np.random.default_rng(5).normal(size=len(dst)))
    got = ref.split_segment_softmax_bwd(build_row_split(ro, 4), w, g)
    assert got.dtype == torch.float64
    torch.testing.assert_close(
        got, ref.segment_softmax_coo_bwd(dst, w, g, len(lens)), rtol=1e-12,
        atol=1e-12)


def test_split_softmax_is_the_plain_softmax_in_float64():
    """In float64 the unit arithmetic equals the plain softmax up to
    float64 roundings (the order of the sums is the only change)."""
    lens, logits = _softmax_rows(4)
    keep = np.abs(logits) < 1e29
    lg = torch.from_numpy(logits[keep]).double()
    dst = np.repeat(np.arange(len(lens)), lens)[keep]
    ro = torch.from_numpy(np.searchsorted(dst, np.arange(len(lens) + 1)))
    got = ref.split_segment_softmax(build_row_split(ro, 4), lg)
    assert got.dtype == torch.float64
    torch.testing.assert_close(
        got, ref.segment_softmax_coo(torch.from_numpy(dst), lg, len(lens)),
        rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def graphs():
    jg, jmeta = jdata.synthetic_dataset(**SMALL).build()
    tg, _ = tdata.synthetic_dataset(**SMALL).build()
    return jg, jmeta, tg


def _pad(a, n_pad):
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


@pytest.mark.parametrize("chunk", [3, 16])
def test_k4_fold_on_the_row_splits_matches_jax_grad(graphs, chunk):
    """d_emb as K4 folds it: the forward CSR's split over the d_eh rows
    plus the reverse CSR's split over the d_et rows in rev_perm order;
    d_W and d_e_r from the emulated tile kernel; all against jax.vjp."""
    jg, jmeta, tg = graphs
    params = jkgat.init_params(jax.random.key(4), jmeta.n_nodes,
                               jmeta.n_relations, jkgat.KGATConfig())
    g = np.random.default_rng(1).normal(size=tg.n_edges).astype(np.float32)
    keys = ("entity_embed", "w_rel", "rel_embed")

    def logits(p):
        return jkgat.attention_logits({**params, **p}, jg,
                                      jkgat.KGATConfig(ops_backend="ref"))

    _, vjp = jax.vjp(logits, {k: params[k] for k in keys})
    (want,) = vjp(jnp.asarray(_pad(g, jg.n_edges_pad)))
    weights = [torch.tensor(np.asarray(params[k])) for k in keys]
    deh, det, d_w, d_er = ref.transr_bwd_tiles(
        torch.tensor(g), tg.rel_perm, tg.tiles, tg.src, tg.dst, *weights,
        matmul=functools.partial(ref.tf32_matmul, passes=3))
    split = build_row_split(tg.row_offsets, chunk)
    rev_split = build_row_split(tg.rev_row_offsets, chunk)
    assert split.n_split > 0 and rev_split.n_split > 0
    d_emb = (ref.split_segment_sum(split, deh)
             + ref.split_segment_sum(rev_split, det[tg.rev_perm.long()]))
    for k, a in zip(keys, (d_emb, d_w, d_er)):
        np.testing.assert_allclose(a.numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
