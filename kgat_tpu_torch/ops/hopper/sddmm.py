"""K2 wrapper: TransR attention SDDMM over relation tiles
(``csrc/sddmm.cu``).

Replaces ``kgat_tpu/ops/pallas/sddmm.py::_kernel``. The serving forward
calls it once per attention refresh.
"""

from __future__ import annotations

import ctypes

import torch

from kgat_tpu_torch.ops import ref
from kgat_tpu_torch.ops.hopper import build

MAX_EMBED_DIM = 256
MAX_RELATION_DIM = 128


def _relation_ranges(tiles: torch.Tensor):
    """[(r, lo, hi)] ranges of rel_perm per relation, from the tile table
    (tiles of one relation are consecutive and contiguous)."""
    ranges = {}
    for r, start, count in tiles.tolist():
        lo, hi = ranges.get(r, (start, start))
        ranges[r] = (min(lo, start), max(hi, start + count))
    return [(r, lo, hi) for r, (lo, hi) in sorted(ranges.items())]


def sddmm_transr_plain(rel_perm, tiles, src, dst, entity_embed, w_rel,
                       rel_embed) -> torch.Tensor:
    """Plain PyTorch version of :func:`sddmm_transr`: one pair of matmuls
    per relation, as ``kgat_tpu.models.kgat.attention_logits`` does."""
    return ref.transr_logits(rel_perm, _relation_ranges(tiles), src, dst,
                             entity_embed, w_rel, rel_embed)


def sddmm_transr(rel_perm: torch.Tensor, tiles: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor,
                 entity_embed: torch.Tensor, w_rel: torch.Tensor,
                 rel_embed: torch.Tensor) -> torch.Tensor:
    """Per-edge TransR logits (W_r e_t) . tanh(W_r e_h + e_r) -> (E,)
    float32 in canonical edge order; head = dst, tail = src.

    rel_perm: (E,) int32 canonical edge ids grouped by relation; tiles:
    (n_tiles, 3) int32 (relation, start, count) ranges of rel_perm that
    together cover it once, each within one relation (``Graph.tiles``);
    src/dst: (E,) int32; entity_embed: (n_nodes, d), w_rel: (R, d, k),
    rel_embed: (R, k), all float32. CPU tensors take
    :func:`sddmm_transr_plain`; CUDA tensors launch the kernel.
    """
    args = (rel_perm, tiles, src, dst, entity_embed, w_rel, rel_embed)
    if not build.use_kernel("sddmm_transr", *args):
        return sddmm_transr_plain(*args)
    for name, t in (("rel_perm", rel_perm), ("src", src), ("dst", dst)):
        build.check_tensor(name, t, (torch.int32,), 1)
    build.check_tensor("tiles", tiles, (torch.int32,), 2)
    build.check_tensor("entity_embed", entity_embed, (torch.float32,), 2)
    build.check_tensor("w_rel", w_rel, (torch.float32,), 3)
    build.check_tensor("rel_embed", rel_embed, (torch.float32,), 2)
    n_rel, d, k = w_rel.shape
    if not (rel_perm.shape == src.shape == dst.shape):
        raise ValueError("rel_perm, src and dst must be equally long")
    if tiles.shape[1] != 3:
        raise ValueError(f"tiles {tuple(tiles.shape)} must be (n_tiles, 3)")
    if entity_embed.shape[1] != d or rel_embed.shape != (n_rel, k):
        raise ValueError(f"entity_embed {tuple(entity_embed.shape)}, "
                         f"w_rel {tuple(w_rel.shape)} and rel_embed "
                         f"{tuple(rel_embed.shape)} disagree")
    if not (0 < d <= MAX_EMBED_DIM and 0 < k <= MAX_RELATION_DIM):
        raise ValueError(f"d={d} or k={k} beyond the kernel's "
                         f"{MAX_EMBED_DIM}/{MAX_RELATION_DIM}")
    out = torch.empty(rel_perm.shape, dtype=torch.float32,
                      device=entity_embed.device)
    n_tiles = tiles.shape[0]
    if n_tiles == 0:
        return out
    lib = build.library()
    with torch.cuda.device(entity_embed.device):
        code = lib.kgat_sddmm_transr(
            *(t.data_ptr() for t in args), out.data_ptr(), n_tiles, d, k,
            ctypes.c_void_p(build.stream_ptr(entity_embed.device)))
    build.check_launch(lib, code, "sddmm_transr")
    build.launch_counts["sddmm_transr"] += 1
    return out
