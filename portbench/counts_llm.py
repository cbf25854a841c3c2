"""Operations and bytes of the Moonlight cell, counted from shapes: the
model's FLOPs per batch (the encoder's active FLOPs in bf16, the fusion
stack's in fp32) and the new kernels' operations and bytes per call.

Encoder, forward, per real token of every encoder row the batch sends
(``counts.BLOCKS``' packed tables, unique tables or dense grids, as
:func:`counts.bert_rows` reads them), per layer: the four attention
projections ``2 D (H dq + (r + dr)) + 2 r H (dn + dv) + 2 H dv D``; per
pair of one segment that the causal mask keeps (l (l + 1) / 2 for a
segment of l tokens) ``2 H (dq + dv)``; the dense layer's SwiGLU ``6 D F``;
an expert layer's ``k`` routed and the shared SwiGLUs ``6 D I (k + s)``.
The router (``2 D E`` per token and expert layer, fp32) counts with the
fp32 FLOPs. Embedding lookups, norms, RoPE, softmax and the combine are
not counted. A training step adds twice the forward of the fusion stack
(LOCK_BERT: the encoder runs without a graph).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench import counts


def causal_pairs(block: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(real tokens, key-query pairs the causal mask keeps) of the encoder
    rows of one collated block."""
    if "bert_packed" in block:
        seg = np.asarray(block["bert_packed_seg"])
        real = seg > 0
        keys = np.nonzero(real)[0] * (seg.max() + 1) + seg[real]
        _, lens = np.unique(keys, return_counts=True)
    else:
        ids = block["bert_unique"] if "bert_unique" in block else (
            block["bert"].reshape(-1, block["bert"].shape[-1]))
        lens = (np.asarray(ids) != 0).sum(axis=1)
        lens = lens[lens > 0]
    lens = lens.astype(np.int64)
    return int(lens.sum()), int((lens * (lens + 1) // 2).sum())


def encoder_flops(blocks, c) -> Dict[str, float]:
    """{'bf16': the encoder's active FLOPs, 'fp32': the router's} of the
    encoder rows of ``blocks`` (``c``: the encoder's config)."""
    D, H = c.hidden_size, c.num_attention_heads
    dn, dr, dv, r = (c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim,
                     c.kv_lora_rank)
    dq = dn + dr
    tokens = pairs = 0
    for block in blocks:
        t, p = causal_pairs(block)
        tokens, pairs = tokens + t, pairs + p
    proj = 2 * D * (H * dq + r + dr) + 2 * r * H * (dn + dv) + 2 * H * dv * D
    attn = 2 * H * (dq + dv)
    dense = c.first_k_dense_replace
    moe = c.num_hidden_layers - dense
    ffn = (dense * 6 * D * c.intermediate_size
           + moe * 6 * D * c.moe_intermediate_size
           * (c.num_experts_per_tok + c.n_shared_experts))
    per_token = c.num_hidden_layers * proj + ffn
    return {"bf16": float(tokens * per_token
                          + c.num_hidden_layers * pairs * attn),
            "fp32": float(tokens * moe * 2 * D * c.n_routed_experts)}


def model_flops(model, batch, train: bool) -> Dict[str, float]:
    """{'bert': FLOPs in bf16, 'fp32': FLOPs in fp32} of one collated
    batch (``model``: the reference RUArtModel over the Moonlight
    encoder)."""
    q, ocr, od = batch[:3]
    enc = encoder_flops((q, ocr, od), model.spec.bert)
    fusion = counts.lstm_flops(model, q, ocr, od) + counts.fusion_flops(
        model, counts.fusion_sizes(q, ocr, od))
    return {"bert": enc["bf16"],
            "fp32": enc["fp32"] + fusion * (3 if train else 1)}


def moe_gemm_launch(rows: int, n: int, k: int, experts_used: int,
                    weight_rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one grouped-GEMM launch over ``rows`` routed rows
    of width ``k`` into ``n`` output columns: 2 rows n' k (n' = the
    weight's rows: 2n for gate/up), the weights of the experts that got
    rows (``experts_used`` x ``weight_rows`` x k bf16) read once, the rows
    read and the output written once (bf16)."""
    flops = 2.0 * rows * weight_rows * k
    nbytes = 2.0 * (experts_used * weight_rows * k + rows * k + rows * n)
    return flops, nbytes


def moe_window(load: np.ndarray, steps: int, c) -> Dict[str, float]:
    """The grouped GEMM's FLOPs and bytes over a window of ``steps`` train
    steps, from the per-expert routed-row counter's change over it
    (``load`` [expert layers, E]). Each launch is taken to read the weights
    of every expert the window's counter shows with rows in that layer."""
    D, W = c.hidden_size, c.moe_intermediate_size
    steps = max(steps, 1)
    flops = nbytes = 0.0
    for layer in np.asarray(load):
        rows = float(layer.sum()) / steps   # a launch's, on average
        used = int((layer > 0).sum())
        for n, k, wrows in ((W, D, 2 * W), (D, W, D)):
            f, b = moe_gemm_launch(rows, n, k, used, wrows)
            flops, nbytes = flops + f * steps, nbytes + b * steps
    return {"flops": flops, "bytes": nbytes, "dtype": "bfloat16"}


def mla_call(rows: int, length: int, heads: int, dq: int, dv: int,
             bias_dim: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one latent-attention call on [rows, length]
    tokens: Q K^T over dq and P V over dv for every query and key of a row
    (2 L^2 H (dq + dv) per row), q, k (dq wide), v (dv wide) read once, the
    fp32 bias read once, the output (dv wide) written once, bf16."""
    flops = 2.0 * rows * length * length * heads * (dq + dv)
    bias = rows * length * (length if bias_dim == 3 else 1) * 4
    nbytes = 2.0 * rows * length * heads * (2 * dq + 2 * dv) + bias
    return flops, float(nbytes)
