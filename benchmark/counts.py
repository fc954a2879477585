"""The yardstick's arithmetic, frozen: the card's published peaks, and the
operations and bytes a CF step, a KG step and an epoch need, counted from
shapes and from the data.

The SpMM's bytes are ``kgat_tpu_torch/ops/hopper/segment_sum.py::
spmm_bytes`` at commit d0f90ce, counted over what the data needs: x read
once, one (src, weight) per distinct (dst, src) pair, the offsets and the
float32 output, so that a change of layout or of coalescing moves a
kernel's share of its roofline and not the yardstick. The peaks are those
of ``chip_smoke.py`` at the same commit (NVIDIA's data sheet, H100 SXM,
dense, at the 700 W limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

_STREAM_BYTES = {None: 4, "bf16": 2, "fp8": 1}


def spmm_bytes(n_rows: int, n_pairs: int, n_in: int, d: int,
               elt: int) -> int:
    """One SpMM call: x (n_in, d) of ``elt``-byte values read once, a
    4-byte src and a 4-byte weight per distinct pair, the n_rows + 1
    offsets and the (n_rows, d) float32 output."""
    return n_in * d * elt + n_pairs * 8 + (n_rows + 1) * 4 + n_rows * d * 4


def spmm_flops(n_pairs: int, d: int) -> int:
    return 2 * n_pairs * d


def spmm_least_s(n_rows: int, n_pairs: int, n_in: int, d: int,
                 elt: int) -> float:
    """The least time of one SpMM call on the card: bytes over the HBM
    rate or float32 operations over the float32 peak, the larger."""
    return max(spmm_bytes(n_rows, n_pairs, n_in, d, elt) / HBM_BYTES_PER_S,
               spmm_flops(n_pairs, d) / F32_FLOPS)


def layer_dims(model_cfg: dict):
    """(d_in, d_out) of each propagation layer."""
    dims, d_in = [], model_cfg["embed_dim"]
    for d_out in model_cfg["conv_dims"]:
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def k1_least_s_per_cf_step(sizes: dict, model_cfg: dict) -> float:
    """The least time of a CF step's SpMMs: one per layer forward over
    the dst rows and one per layer backward (the features' gradient) over
    the src rows, both over the distinct pairs."""
    n, pairs = sizes["n_nodes"], sizes["n_pairs"]
    elt = _STREAM_BYTES[model_cfg.get("compute_dtype")]
    return sum(2 * spmm_least_s(n, pairs, n, d_in, elt)
               for d_in, _ in layer_dims(model_cfg))


def _dense_flops(n: int, d_in: int, d_out: int, aggregator: str) -> int:
    """One layer's aggregator products, forward."""
    if aggregator == "bi-interaction":
        return 2 * (2 * n * d_in * d_out)
    if aggregator == "graphsage":
        return 2 * n * 2 * d_in * d_out
    return 2 * n * d_in * d_out


def cf_step_flops(sizes: dict, model_cfg: dict, batch: int) -> int:
    """A CF step's forward and backward: per layer the SpMM (forward, and
    its features' gradient) and the aggregator's products (forward, and
    the two products of their backward); the BPR scores."""
    n, pairs = sizes["n_nodes"], sizes["n_pairs"]
    total = 0
    for d_in, d_out in layer_dims(model_cfg):
        total += 2 * spmm_flops(pairs, d_in)
        total += 3 * _dense_flops(n, d_in, d_out, model_cfg["aggregator"])
    out_dim = model_cfg["embed_dim"] + sum(model_cfg["conv_dims"])
    return total + 3 * (2 * 2 * batch * out_dim)


def kg_step_flops(model_cfg: dict, batch: int) -> int:
    """A KG step: three TransR projections per triple, forward, and the
    two products of each in the backward."""
    d, k = model_cfg["embed_dim"], model_cfg["relation_dim"]
    return 3 * (3 * 2 * batch * d * k)


def attention_flops(sizes: dict, model_cfg: dict) -> int:
    """One attention recompute, forward only: each distinct (node,
    relation) pair projected once, and per edge a tanh and a dot of k."""
    d, k = model_cfg["embed_dim"], model_cfg["relation_dim"]
    return 2 * sizes["n_node_rel"] * d * k + 3 * sizes["n_edges"] * k


def epoch_flops(sizes: dict, model_cfg: dict, train: dict, n_cf: int,
                n_kg: int) -> int:
    """An epoch's forward and backward passes: ``n_cf`` CF steps, ``n_kg``
    KG steps and one attention recompute. Adam and recomputed work are
    not counted."""
    return (n_cf * cf_step_flops(sizes, model_cfg, train["cf_batch_size"])
            + n_kg * kg_step_flops(model_cfg, train["kg_batch_size"])
            + attention_flops(sizes, model_cfg))
