"""Port parity: DGL's ``update_all`` / ``apply_edges`` op surface.

``kgat_tpu_torch.ops``' ``ref`` and ``hopper`` backends against
``kgat_tpu.ops.ref`` and the pallas backend (its Pallas SpMM in interpret
mode), as ``tests/test_ops_ref.py`` runs them, on one numpy-seeded graph
built by both packages (one canonical edge order) with rows that have no
in-edge. Edge data crosses over by ``[: n_edges]`` and a pad. Here
the hopper backend's K1 route runs K1's plain version, as every wrapper
does for CPU tensors; ``tests/test_torch_cuda.py`` holds the kernel to it
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kgat_tpu.graph import build_graph as jbuild_graph
from kgat_tpu.ops import get_backend as jget_backend
from kgat_tpu.ops import ref as jref
from kgat_tpu_torch.graph import build_graph
from kgat_tpu_torch.ops import get_backend, hopper_backend, ref
from kgat_tpu_torch.recommend import disable_tf32

import torch_threads  # noqa: F401  (one intra-op thread)

N_NODES, N_EDGES, N_REL, D = 23, 140, 5, 16
# The JAX backend each port backend is held to.
PAIRS = [("ref", "ref"), ("hopper", "pallas")]


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


@pytest.fixture(scope="module")
def graphs():
    rs = np.random.default_rng(1234)
    src = rs.integers(0, N_NODES, N_EDGES)
    # The last three nodes have no in-edge: empty rows.
    dst = rs.integers(0, N_NODES - 3, N_EDGES)
    ety = rs.integers(0, N_REL, N_EDGES)
    return (jbuild_graph(src, dst, ety, N_NODES, N_REL),
            build_graph(src, dst, ety, N_NODES, N_REL))


def _pad(a, n_pad):
    """Real-edge values -> the JAX graph's (E_pad, ...), pad slots 1: JAX
    masks pad edges after the message, so a 0 divisor there would put
    NaN into its u_div_e gradient."""
    out = np.ones((n_pad,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def _inputs(msg, seed=0):
    """x (n, d) and the edge data a message reads, as numpy."""
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(N_NODES, D)).astype(np.float32)
    if msg in ("copy_e", "u_add_e", "u_sub_e"):
        w = rs.normal(size=(N_EDGES, D)).astype(np.float32)
    elif msg == "u_div_e":
        w = (0.5 + rs.random(N_EDGES)).astype(np.float32)  # nonzero
    else:
        w = rs.normal(size=N_EDGES).astype(np.float32)
    return x, w


def _jax_call(backend, fn):
    if backend == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return fn()
    return fn()


@pytest.mark.parametrize("msg", ["copy_u", "copy_e", "u_mul_e", "u_add_e",
                                 "u_sub_e", "u_div_e"])
@pytest.mark.parametrize("reduce", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("pair", PAIRS, ids=["ref", "hopper"])
def test_gspmm_matches_kgat_tpu(graphs, msg, reduce, pair):
    jg, tg = graphs
    x, w = _inputs(msg)
    want = np.asarray(_jax_call(pair[1], lambda: jget_backend(pair[1]).gspmm(
        jg, msg, reduce, jnp.asarray(x),
        jnp.asarray(_pad(w, jg.n_edges_pad)))))
    got = get_backend(pair[0]).gspmm(tg, msg, reduce, torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (N_NODES, D)
    # Rows without an in-edge: 0 for sum and mean, -inf for max, +inf
    # for min, as jax.ops.segment_* gives.
    empty = {"sum": 0.0, "mean": 0.0, "max": -np.inf, "min": np.inf}[reduce]
    assert (got[-3:] == empty).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("msg", ["copy_u", "copy_e", "u_mul_e", "u_add_e",
                                 "u_sub_e", "u_div_e"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("pair", PAIRS, ids=["ref", "hopper"])
def test_gspmm_gradients_match_jax_grad(graphs, msg, reduce, pair):
    """d/dx and d/d(edge data) of <gspmm(...), cot> against jax.grad."""
    jg, tg = graphs
    x, w = _inputs(msg, seed=1)
    cot = np.random.default_rng(2).normal(size=(N_NODES, D)).astype(
        np.float32)
    be = jget_backend(pair[1])

    def loss(x_, w_):
        return jnp.sum(be.gspmm(jg, msg, reduce, x_, w_) * cot)
    jx, jw = _jax_call(pair[1], lambda: jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(_pad(w, jg.n_edges_pad))))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (get_backend(pair[0]).gspmm(tg, msg, reduce, tx, tw)
     * torch.from_numpy(cot)).sum().backward()
    if msg != "copy_e":
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx),
                                   rtol=1e-3, atol=1e-5)
    if msg != "copy_u":
        np.testing.assert_allclose(tw.grad.numpy(),
                                   np.asarray(jw)[:N_EDGES], rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("msg,reduce,edge_dim,routed", [
    ("u_mul_e", "sum", 1, True), ("u_mul_e", "mean", 1, True),
    ("copy_u", "sum", None, True), ("copy_u", "mean", None, True),
    ("u_mul_e", "sum", 2, False), ("u_mul_e", "max", 1, False),
    ("copy_u", "min", None, False), ("copy_e", "sum", 2, False),
    ("u_add_e", "mean", 2, False)])
def test_hopper_gspmm_routes_sum_and_mean_through_k1(
        graphs, monkeypatch, msg, reduce, edge_dim, routed):
    """The cases ``kgat_tpu``'s pallas backend sends through its Pallas
    SpMM go through K1's differentiable wrapper (``spmm``): u_mul_e with
    (E,) weights and copy_u (unit weights), with sum or mean; every other
    case takes the plain path. Both give ref's result."""
    _, tg = graphs
    calls = []
    real = hopper_backend.spmm

    def spy(graph, edge_w, x):
        calls.append(edge_w)
        return real(graph, edge_w, x)
    monkeypatch.setattr(hopper_backend, "spmm", spy)
    rs = np.random.default_rng(3)
    x = torch.from_numpy(rs.normal(size=(N_NODES, D)).astype(np.float32))
    w = None if edge_dim is None else torch.from_numpy(
        rs.normal(size=(N_EDGES,) + ((D,) if edge_dim == 2 else ())).astype(
            np.float32))
    got = hopper_backend.gspmm(tg, msg, reduce, x, w)
    assert bool(calls) == routed
    if msg == "copy_u" and routed:
        assert torch.equal(calls[0], torch.ones(N_EDGES))
    torch.testing.assert_close(got, ref.gspmm(tg, msg, reduce, x, w),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot",
                                "copy_lhs", "copy_rhs"])
@pytest.mark.parametrize("targets", [("u", "v"), ("u", "e"), ("e", "v"),
                                     ("v", "u")])
@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_gsddmm_matches_kgat_tpu(graphs, op, targets, backend):
    jg, tg = graphs
    lt, rt = targets
    rs = np.random.default_rng(4)

    def operand(t):
        a = rs.normal(size=(N_NODES if t in ("u", "v") else N_EDGES,
                            6)).astype(np.float32)
        return a + 2.0 if op == "div" else a  # keep divisors away from 0

    lhs, rhs = operand(lt), operand(rt)
    jarg = lambda a, t: jnp.asarray(  # noqa: E731
        _pad(a, jg.n_edges_pad) if t == "e" else a)
    want = np.asarray(jref.gsddmm(jg, op, jarg(lhs, lt), jarg(rhs, rt),
                                  lhs_target=lt,
                                  rhs_target=rt))[:N_EDGES]
    got = get_backend(backend).gsddmm(tg, op, torch.from_numpy(lhs),
                                      torch.from_numpy(rhs), lhs_target=lt,
                                      rhs_target=rt).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["ref", "hopper"])
def test_sddmm_dot_and_segment_reductions_match_kgat_tpu(graphs, backend):
    jg, tg = graphs
    be = get_backend(backend)
    rs = np.random.default_rng(5)
    a, b = (rs.normal(size=(N_NODES, 8)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        be.sddmm_dot(tg, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jref.sddmm_dot(jg, jnp.asarray(a),
                                  jnp.asarray(b)))[:N_EDGES],
        rtol=1e-4, atol=1e-6)
    v = rs.normal(size=(N_EDGES, 4)).astype(np.float32)
    for name in ("segment_sum", "segment_max", "segment_min",
                 "segment_mean"):
        got = getattr(be, name)(tg, torch.from_numpy(v)).numpy()
        want = np.asarray(getattr(jref, name)(
            jg, jnp.asarray(_pad(v, jg.n_edges_pad))))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_unknown_ops_are_refused(graphs):
    _, tg = graphs
    x = torch.zeros(N_NODES, 2)
    for backend in ("ref", "hopper"):
        be = get_backend(backend)
        assert be.MSG_OPS == tuple(jref.MSG_OPS)
        assert be.REDUCE_OPS == tuple(jref.REDUCE_OPS)
        with pytest.raises(ValueError, match="msg"):
            be.gspmm(tg, "u_pow_e", "sum", x, x)
        with pytest.raises(ValueError, match="reduce"):
            be.gspmm(tg, "copy_u", "prod", x)
        with pytest.raises(ValueError, match="target"):
            be.gsddmm(tg, "add", x, x, lhs_target="w")
        with pytest.raises(ValueError, match="op"):
            be.gsddmm(tg, "pow", x, x)
