"""The single-process, kernel-free stand-ins of the port's parallel and
kernel modules that the frozen reference imports.

Attention is the plain softmax attention (fp32 scores and softmax,
probabilities cast to the input's dtype, fp32 sums), run under autograd
for training. Every mesh helper is its one-rank identity. The int8
encoder, image-feature packs, PHOC tables and the native collator are not
part of the reference: they raise, and the collator collates with numpy.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def attention_rows_plain(q, k, v, bias, heads: int) -> torch.Tensor:
    """Model-layout attention: q/k/v [B, L, H*dh], ``bias`` a float32
    [B, L] key bias or [B, L, L] per-query bias."""
    B, L, D = q.shape
    dh = D // heads
    qh = q.reshape(B, L, heads, dh).float()
    kh = k.reshape(B, L, heads, dh).float()
    vh = v.reshape(B, L, heads, dh).float()
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh) / torch.tensor(
        float(dh), dtype=torch.float32).sqrt()
    if bias.dim() == 3:
        s = s + bias[:, None].float()
    else:
        s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", p, vh)
    return ctx.reshape(B, L, D).to(q.dtype)


fused_attention = attention_rows_plain


def sharded_fused_attention(*args, **kwargs):
    raise NotImplementedError("the reference runs on one process")


class QuantLinear(nn.Module):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the reference has no int8 encoder")


def mark_sharded(module: nn.Module, **dims: int) -> nn.Module:
    return module


def tp_dim(param: torch.Tensor) -> Optional[int]:
    return None


def param_dim(name: str, shape, tp: int, heads: Optional[int] = None):
    return None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        raise NotImplementedError("the reference runs on one process")
    return x


def row_range(n: int, parts: int, index: int):
    per = -(-n // parts)
    a = min(index * per, n)
    return a, min(a + per, n)


def gather_rows(part: torch.Tensor, a: int, n: int, group) -> torch.Tensor:
    return all_reduce(part, group)


def vocab_embedding(num_embeddings: int, embedding_dim: int,
                    dim: Optional[int], mesh) -> nn.Embedding:
    if dim is not None:
        raise NotImplementedError("the reference runs on one process")
    return nn.Embedding(num_embeddings, embedding_dim)


class HDF5ImageFeatures:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the reference reads no image features")


def build_phoc_embedding(*args, **kwargs):
    raise NotImplementedError("the reference has no PHOC tables")


def load_fastcollate():
    raise RuntimeError("the reference collates with numpy")
