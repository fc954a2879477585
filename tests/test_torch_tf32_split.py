"""The arithmetic of K2 on the tensor cores, emulated on the CPU.

K2 (``csrc/sddmm.cu``) forms each TransR projection in three TF32 passes,
x w ~ x_hi w_hi + x_hi w_lo + x_lo w_hi with hi = tf32(x) and lo =
tf32(x - hi). ``ops.ref.tf32_round`` and ``tf32_matmul`` repeat that
arithmetic in plain PyTorch. Here the emulated logits are held against
``kgat_tpu.ops.pallas.sddmm.sddmm_transr`` (interpret mode,
``Precision.HIGHEST``) at d = k = 64 with Xavier-scaled inputs, at rtol
1e-5 and atol 1e-7: three passes meet it, one pass does not. At this scale
the logits are about 0.01, so the forward tolerance elsewhere (1e-4)
would not tell the two apart.

K4 (``csrc/sddmm_bwd.cu``) runs K2's backward, six products an edge, in
the same three passes; ``ops.ref.transr_bwd_tiles`` repeats its
arithmetic (d_W by 8-edge steps, each formed apart and added in float32)
and is held against ``kgat_tpu.ops.pallas.sddmm.sddmm_transr_bwd`` the
same way, at rtol 1e-5. Its per-edge rows d_eh meet atol 1e-7. d_et, d_W
and d_e_r cannot: float32 products summed in K4's order (``torch.matmul``
in place of the TF32 passes) already need atol 1.52e-7, 1.92e-7 and
2.94e-7 to meet the Pallas kernel there (it sums 1,024-edge tiles in
another order, and its d_pt takes XLA's tanh). Those three are held at
twice that, rounded up: 3.1e-7, 3.9e-7 and 5.9e-7, as the three passes
are held to twice float32's error elsewhere; a test pins the float32
reading. One TF32 pass misses by over 100x.

The tensor cores add an MMA's products into its accumulator with
truncation (Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
NVIDIA tensor cores", 2021). ``_mma`` models that, and shows why K2 runs
each 8-wide step of d from a zero accumulator and adds the steps with a
rounding float32 add: chaining every MMA of a projection into one
accumulator would leave the logits about three times further from float64
than float32 leaves them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgat_tpu.ops.pallas.sddmm import sddmm_transr as jax_sddmm_transr
from kgat_tpu.ops.pallas.sddmm import sddmm_transr_bwd as jax_sddmm_bwd
from kgat_tpu_torch.ops import ref

import torch_threads  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 1e-5, 1e-7
TILE = 1024            # the Pallas kernel's relation tile
N_REL, PER_REL = 4, 5 * TILE
N_NODES, D, K = 5000, 64, 64


def _xavier(rs, shape, fan):
    lim = np.sqrt(6.0 / fan)
    return rs.uniform(-lim, lim, shape).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """20,480 edges, 5 relation tiles of 1,024 per relation, inputs at the
    Xavier scale of ``chip_smoke.random_inputs``; the JAX logits."""
    rs = np.random.default_rng(0)
    emb = _xavier(rs, (N_NODES, D), N_NODES + D)
    w_rel = _xavier(rs, (N_REL, D, K), D + K)
    rel_embed = _xavier(rs, (N_REL, K), N_REL + K)
    n_edges = N_REL * PER_REL
    src = rs.integers(0, N_NODES, n_edges).astype(np.int32)
    dst = rs.integers(0, N_NODES, n_edges).astype(np.int32)
    # Edges grouped by relation: edge e has relation e // PER_REL.
    tile_rel = np.repeat(np.arange(N_REL, dtype=np.int32), PER_REL // TILE)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax_sddmm_transr(
            jnp.asarray(emb[dst]), jnp.asarray(emb[src]), jnp.asarray(w_rel),
            jnp.asarray(rel_embed), jnp.asarray(tile_rel), TILE,
            precision=jax.lax.Precision.HIGHEST, interpret=True)
    ranges = [(r, r * PER_REL, (r + 1) * PER_REL) for r in range(N_REL)]
    args = (torch.arange(n_edges, dtype=torch.int32), ranges,
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(emb), torch.from_numpy(w_rel),
            torch.from_numpy(rel_embed))
    return args, np.asarray(want)


def _logits(args, passes):
    return ref.transr_logits(*args, matmul=functools.partial(
        ref.tf32_matmul, passes=passes)).numpy()


def test_three_tf32_passes_match_the_pallas_kernel(case):
    args, want = case
    # The logits are about 0.01 here, where atol 1e-7 is a relative 1e-5.
    assert 1e-3 < np.abs(want).mean() < 1e-1
    np.testing.assert_allclose(_logits(args, 3), want, rtol=RTOL, atol=ATOL)


def test_one_tf32_pass_does_not(case):
    args, want = case
    got = _logits(args, 1)
    assert not np.allclose(got, want, rtol=RTOL, atol=ATOL)
    # It keeps only about 11 bits: errors near 1e-6, against 1e-9.
    assert np.abs(got - want).max() > 10 * ATOL


def test_three_passes_are_as_close_to_float64_as_float32(case):
    """Against float64, the three passes' worst error is within twice the
    plain float32 path's: the criterion K2 is held to on the card."""
    args, _ = case
    f64 = ref.transr_logits(*args[:4], *(t.double() for t in args[4:]))
    f32 = ref.transr_logits(*args)
    err3 = np.abs(_logits(args, 3) - f64.numpy()).max()
    err32 = np.abs(f32.numpy() - f64.numpy()).max()
    assert err3 <= 2 * err32, (err3, err32)


K4_NAMES = ("d_eh", "d_et", "d_w_rel", "d_rel_embed")
K4_ATOL = (1e-7, 3.1e-7, 3.9e-7, 5.9e-7)


@pytest.fixture(scope="module")
def k4_case(case):
    """K4 on the edges of ``case`` with a cotangent of unit scale, as
    chip_smoke's: the Pallas kernel's gradients, and the arguments of
    ``ref.transr_bwd_tiles`` over relation tiles of 256 edges (the port's
    ``Graph.tiles``)."""
    args, _ = case
    rel_perm, _, src, dst, emb, w_rel, rel_embed = args
    n_edges = rel_perm.shape[0]
    g = np.random.default_rng(3).normal(size=n_edges).astype(np.float32)
    tile_rel = np.repeat(np.arange(N_REL, dtype=np.int32), PER_REL // TILE)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax_sddmm_bwd(
            jnp.asarray(g), jnp.asarray(emb.numpy()[dst.numpy()]),
            jnp.asarray(emb.numpy()[src.numpy()]), jnp.asarray(w_rel.numpy()),
            jnp.asarray(rel_embed.numpy()), jnp.asarray(tile_rel), TILE,
            precision=jax.lax.Precision.HIGHEST, interpret=True)
    tiles = torch.tensor([(r, s, 256) for r in range(N_REL)
                          for s in range(r * PER_REL, (r + 1) * PER_REL, 256)],
                         dtype=torch.int32)
    return ((torch.from_numpy(g), rel_perm, tiles, src, dst),
            (emb, w_rel, rel_embed), [np.asarray(w) for w in want])


def _k4(k4_case, matmul, dtype=torch.float32):
    head, weights, _ = k4_case
    return ref.transr_bwd_tiles(head[0].to(dtype), *head[1:],
                                *(w.to(dtype) for w in weights),
                                matmul=matmul)


def test_k4_three_tf32_passes_match_the_pallas_kernel(k4_case):
    got = _k4(k4_case, functools.partial(ref.tf32_matmul, passes=3))
    for name, a, b, atol in zip(K4_NAMES, got, k4_case[2], K4_ATOL):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=atol,
                                   err_msg=name)


def test_k4_float32_order_needs_the_wider_atol(k4_case):
    """Why d_et, d_W and d_e_r are not held at atol 1e-7: float32 products
    summed in K4's order miss it there, and meet half their atol."""
    got = _k4(k4_case, torch.matmul)
    for name, a, b, atol in zip(K4_NAMES, got, k4_case[2], K4_ATOL):
        need = float((np.abs(a.numpy().astype(np.float64) - b)
                      - RTOL * np.abs(b)).max())
        assert need <= atol / 2, (name, need)
        assert (need > ATOL) == (atol > ATOL), (name, need)


def test_k4_one_tf32_pass_does_not(k4_case):
    got = _k4(k4_case, functools.partial(ref.tf32_matmul, passes=1))
    for name, a, b, atol in zip(K4_NAMES, got, k4_case[2], K4_ATOL):
        err = np.abs(a.numpy() - b)
        assert (err / (atol + RTOL * np.abs(b))).max() > 100, name


def test_k4_three_passes_are_as_close_to_float64_as_float32(k4_case):
    """Each of K4's outputs, from the emulated tensor cores and from
    float32 products summed in the same order, against float64: the three
    passes' worst error is within twice the float32 one's, the criterion
    chip_smoke holds K4 to on the card."""
    f64 = _k4(k4_case, torch.matmul, torch.float64)
    err = {}
    for how, mm in (("tf32x3", functools.partial(ref.tf32_matmul, passes=3)),
                    ("f32", torch.matmul)):
        err[how] = [float((a.double() - b).abs().max())
                    for a, b in zip(_k4(k4_case, mm), f64)]
    for name, e3, e32 in zip(K4_NAMES, err["tf32x3"], err["f32"]):
        assert e3 <= 2 * e32, (name, e3, e32)


@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -11, 1 + 2 ** -10),        # a tie rounds away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -12, 1.0),                 # below half an ulp rounds down
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),     # 1.5 ulp: up
    (2 - 2 ** -23, 2.0),                 # the carry reaches the exponent
    (0.0, 0.0),
])
def test_tf32_round_is_round_to_nearest_away(x, want):
    got = ref.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_hi_plus_lo_keeps_float32_accuracy():
    """hi + lo is within 2^-22 |x| of x: the split loses no more than the
    dropped lo * lo product."""
    rs = np.random.default_rng(1)
    x = torch.from_numpy(rs.normal(size=100_000).astype(np.float32)
                         * np.float32(10.0) ** rs.integers(-20, 20, 100_000))
    hi = ref.tf32_round(x)
    lo = ref.tf32_round(x - hi)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())


def _tf32(x):
    return ref.tf32_round(torch.from_numpy(
        np.ascontiguousarray(x, np.float32))).numpy().astype(np.float64)


def _toward_zero_f32(x):
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y.astype(np.float64)


def _mma(c, a, b):
    """One m16n8k8 TF32 MMA as the tensor cores add it: the products
    exact, every term aligned to the largest one's exponent and cut to 24
    bits toward zero, the sum cut to float32 toward zero."""
    terms = np.concatenate([a[:, :, None] * b[None], c[:, None]], axis=1)
    top = np.abs(terms).max(axis=1, keepdims=True)
    q = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    return _toward_zero_f32((np.trunc(terms / q) * q).sum(axis=1))


def _cut_tf32(x):
    """float32 ``x`` as the tensor cores read a TF32 operand: its 13 low
    mantissa bits dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32) & ~0x1FFF
    return bits.view(np.float32).astype(np.float64)


def _projection(x, w, per_step):
    """x @ w in three TF32 passes of 8-wide steps, as K2 splits them (x's
    low part handed to the tensor cores as x - hi, which they cut):
    chained into one accumulator, or each step from zero, added with a
    rounding add."""
    xh, wh = _tf32(x), _tf32(w)
    xl = _cut_tf32(x.astype(np.float32) - xh.astype(np.float32))
    wl = _tf32(w - wh)
    acc = np.zeros((x.shape[0], w.shape[1]))
    for s in range(0, x.shape[1], 8):
        k = slice(s, s + 8)
        step = np.zeros_like(acc) if per_step else acc
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            step = _mma(step, a[:, k], b[k])
        acc = (acc.astype(np.float32) + step.astype(np.float32)
               ).astype(np.float64) if per_step else step
    return acc.astype(np.float32)


@pytest.mark.parametrize("n_nodes", [136_880, 100])
def test_steps_from_zero_keep_float32_accuracy(n_nodes):
    """Xavier-scaled rows of a graph of ``n_nodes`` (yelp2018's, and the
    hand-made graph's of chip_smoke): logits from the modelled tensor
    cores against float64, beside those of float32 projections."""
    rs = np.random.default_rng(2)
    m = 5000
    eh, et = (_xavier(rs, (m, D), n_nodes + D) for _ in range(2))
    w = _xavier(rs, (D, K), D + K)
    er = _xavier(rs, (K,), N_REL + K)

    def logit(ph, pt):
        return (pt.astype(np.float64) * np.tanh(ph.astype(np.float64)
                                                + er)).sum(1)
    want = logit(eh.astype(np.float64) @ w, et.astype(np.float64) @ w)
    err32 = np.abs(logit(eh @ w, et @ w) - want).max()
    err = {per_step: np.abs(logit(_projection(eh, w, per_step),
                                  _projection(et, w, per_step)) - want).max()
           for per_step in (True, False)}
    assert err[True] <= 1.5 * err32, (err, err32)
    assert err[False] >= 2 * err32, (err, err32)
