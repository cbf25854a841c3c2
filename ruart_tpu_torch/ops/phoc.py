"""PHOC string encoding as tensor ops — port of ``ruart_tpu/ops/phoc.py``.

Encodes whole batches of strings on the tensors' device: the host packs
each (pre-filtered) string into a fixed-shape char-id array
(:func:`encode_char_ids`), and :func:`phoc_from_char_ids` turns character
occupancy into region-overlap indicators with two small einsums instead of
the reference's per-string C loop (`Utils/cphoc.c:32-103`). The JAX
package writes these as XLA einsums, not as a Pallas kernel, so stock
torch ops are their counterpart.

Bit-faithfulness: the >=0.5 overlap rule is evaluated in IEEE float32 in
the C encoder, and float32 division is not rounded alike on every backend
(under XLA-CPU ``5/6`` rounds otherwise than in C and numpy, flipping
knife-edge regions such as those of 3-letter words). The overlap test
depends only on ``(length, position, region)``, a finite domain, so the
region-activity tables are made on the host with numpy float32 (which
matches C exactly) and the tensor op is a gather and two products of
{0, 1} values: no division on the device, and the result equals the
native encoder's byte for byte.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ruart_tpu_torch.core.constants import PHOC_BIGRAMS, PHOC_DIM, PHOC_UNIGRAMS

N_UNI = 36
N_BI = 50
N_REGIONS = 14  # levels 2+3+4+5

# Static (region_start, region_end) tables in cphoc row order
# (level 2 -> rows 0..1, level 3 -> 2..4, level 4 -> 5..8, level 5 -> 9..13).
_REGION_LO = np.concatenate(
    [np.arange(l, dtype=np.float32) / np.float32(l) for l in (2, 3, 4, 5)]
)
_REGION_HI = np.concatenate(
    [(np.arange(l, dtype=np.float32) + 1) / np.float32(l) for l in (2, 3, 4, 5)]
)

_UNI_INDEX = {c: i for i, c in enumerate(PHOC_UNIGRAMS)}
# 36*36 flat bigram lookup: pair (a,b) -> bigram id or -1
_BI_TABLE = np.full((N_UNI * N_UNI,), -1, dtype=np.int64)
for _i, _bg in enumerate(PHOC_BIGRAMS):
    _BI_TABLE[_UNI_INDEX[_bg[0]] * N_UNI + _UNI_INDEX[_bg[1]]] = _i


@functools.lru_cache(maxsize=8)
def _occupancy_tables(max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-made fp32 region-activity tables.

    Returns (uni [max_len+1, max_len, 14], bi [max_len+1, max_len, 2])
    float32 {0,1} arrays: entry [n, i, r] says whether character (resp.
    bigram starting at) position i of an n-char string activates region r,
    evaluated with the exact fp32 arithmetic of `cphoc.c:52-69,89-102`.
    """
    f32 = np.float32
    n_axis = np.arange(1, max_len + 1, dtype=f32)[:, None, None]      # [N,1,1]
    i_axis = np.arange(max_len, dtype=f32)[None, :, None]             # [1,L,1]
    lo = _REGION_LO[None, None, :]                                    # [1,1,14]
    hi = _REGION_HI[None, None, :]

    c0 = (i_axis / n_axis).astype(f32)
    c1 = ((i_axis + f32(1.0)) / n_axis).astype(f32)
    frac = (np.minimum(c1, hi) - np.maximum(c0, lo)) / (c1 - c0)
    uni = (frac >= f32(0.5)).astype(f32)
    uni *= (i_axis < n_axis)  # positions beyond length never fire

    b1 = ((i_axis + f32(2.0)) / n_axis).astype(f32)
    bfrac = (np.minimum(b1, hi[..., :2]) - np.maximum(c0, lo[..., :2])) / (b1 - c0)
    bi = (bfrac >= f32(0.5)).astype(f32)
    bi *= ((i_axis + 1) < n_axis)  # bigram needs i+1 < n

    # prepend the n=0 row (all zeros)
    uni = np.concatenate([np.zeros_like(uni[:1]), uni], axis=0)
    bi = np.concatenate([np.zeros_like(bi[:1]), bi], axis=0)
    return uni, bi


@functools.lru_cache(maxsize=8)
def _device_tables(max_len: int, device: torch.device):
    """The occupancy tables and the bigram lookup on ``device``."""
    uni, bi = _occupancy_tables(max_len)
    return (torch.from_numpy(uni).to(device), torch.from_numpy(bi).to(device),
            torch.from_numpy(_BI_TABLE).to(device))


def encode_char_ids(
    tokens: Sequence[str], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host packing: tokens -> (char_ids [n, max_len] int32 with -1 pad,
    lengths [n] int32). Tokens are filtered like the reference wrapper
    (`Utils/CoQAUtils.py:69-71`) and truncated at ``max_len``."""
    from ruart_tpu_torch.text.phoc import filter_token

    n = len(tokens)
    ids = np.full((n, max_len), -1, dtype=np.int32)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, tok in enumerate(tokens):
        w = filter_token(tok)[:max_len]
        lengths[i] = len(w)
        for j, c in enumerate(w):
            ids[i, j] = _UNI_INDEX[c]
    return ids, lengths


def phoc_from_char_ids(char_ids: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Char ids [..., L] (integers, -1 pad) + lengths [...] -> PHOC
    [..., 604] float32, on ``char_ids``' device.

    The unigram pyramid is an einsum of a gathered [L, 14] region-activity
    mask with a [L, 36] char one-hot; bigrams likewise over 2 regions x 50
    bigrams. All region geometry comes from the host-made fp32 tables.
    ``lengths`` lie in [0, L], as :func:`encode_char_ids` makes them (the
    table gather clamps them there).
    """
    batch_shape = char_ids.shape[:-1]
    L = char_ids.shape[-1]
    device = char_ids.device
    ids = char_ids.reshape(-1, L).long()
    n = lengths.reshape(-1).to(device).long().clamp(0, L)

    uni_tab, bi_tab, bi_lookup = _device_tables(L, device)
    pos = torch.arange(L, device=device)[None, :]
    valid = (ids >= 0) & (pos < n[:, None])

    active = uni_tab.index_select(0, n) * valid[..., None]           # [B,L,14]
    onehot = F.one_hot(torch.where(valid, ids, 0), N_UNI).float()
    onehot = onehot * valid[..., None]
    uni = torch.einsum("blr,blu->bru", active, onehot)
    uni = (uni > 0).float().reshape(-1, N_REGIONS * N_UNI)

    next_ids = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
    pair_valid = valid & (next_ids >= 0) & (pos + 1 < n[:, None])
    flat = torch.where(pair_valid, ids * N_UNI + next_ids.clamp(min=0), 0)
    bi_ids = bi_lookup[flat]                                           # [B,L]
    has_bi = pair_valid & (bi_ids >= 0)

    bactive = bi_tab.index_select(0, n) * has_bi[..., None]           # [B,L,2]
    bi_onehot = F.one_hot(torch.where(has_bi, bi_ids, 0), N_BI).float()
    bi_onehot = bi_onehot * has_bi[..., None]
    bi = torch.einsum("blr,blg->brg", bactive, bi_onehot)
    bi = (bi > 0).float().reshape(-1, 2 * N_BI)

    out = torch.cat([uni, bi], dim=-1)
    return out.reshape(*batch_shape, PHOC_DIM)
