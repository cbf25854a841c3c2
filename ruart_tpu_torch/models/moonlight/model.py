"""The Moonlight-16B-A3B text encoder (DeepSeek-V3 architecture) in
PyTorch, in the slot of RUArt's BERT encoder (``RUArtModel.Bert``).

The published modelling code's forward, layer by layer (x0 = E[ids]):

* h = x + MLA(RMSNorm(x)); x' = h + FFN(RMSNorm(h)); FFN is a SwiGLU of
  ``intermediate_size`` in the first ``first_k_dense_replace`` layers and
  the expert layer after them.
* MLA without query compression: q = W_q x in heads of [nope | rope];
  [c_kv | k_pe] = W_kva x; c_kv <- RMSNorm(c_kv); [k_nope | v] per head =
  W_kvb c_kv; one rope key k_pe shared by the heads; RoPE (theta
  ``rope_theta``, DeepSeek's interleaved pairs, cos/sin in the compute
  type) on q_pe and k_pe at each token's position in its own segment;
  scores [q_nope | q_pe] . [k_nope | k_pe] / sqrt(nope + rope), causal
  within each packed segment; o = W_o (heads of P v). The attention is
  ``ops.attention.fused_attention`` (the bf16 kernel with 192-wide
  query/key and 128-wide value heads on a card, the plain version on the
  CPU).
* The expert layer (``ops.moe``): s = sigmoid(W_g x) in fp32, the top k of
  s + ``e_score_correction_bias`` (the bias chooses only), weights
  s / sum(s) * ``routed_scaling_factor``; y = sum_k w_k SwiGLU_k(x) +
  the shared experts' SwiGLU of width n_shared x ``moe_intermediate_size``.
* RMSNorm takes its statistics in fp32 and rounds once, then scales by its
  weight in the compute type.

What RUArt reads: every layer's output as the published model's
``hidden_states[1:]`` gives them (the last after the final ``norm``),
each widened to fp32, mixed by the α-combine in the layer loop as
``BertModel`` mixes its layers; the LM head is not built. The forward
takes ``BertModel``'s arguments: a packed row's ``segment_ids`` (0 = pad)
and ``position_ids``, else ``attention_mask`` (or all ones) as one segment
at positions 0, 1, ...

Weights are parameters with ``requires_grad`` False, in the compute type
only (bf16 under ``BF16``: 31.2 GB at the published widths, no fp32
copy): the encoder is frozen, never in the optimizer. The experts' gate
and up weights are stacked as ``experts_gate_up`` [E, 2 I, D] (gate
first), their down weights as ``experts_down`` [E, D, I]. Other names
follow the published checkpoint's.

``expert_load`` [expert layers, E] (int64, on the device) counts the rows
routed to each expert, accumulated by the route kernel inside any graph;
``routes``, when set to a list, receives each expert layer's chosen
experts [T, k] (eager calls; a check's aid).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ruart_tpu_torch.models.moonlight.config import MoonlightConfig
from ruart_tpu_torch.ops import moe
from ruart_tpu_torch.ops.attention import MAX_LEN, fused_attention

ATTN_MASK_BIAS = -10000.0


def compute_dtype(c: MoonlightConfig) -> torch.dtype:
    return torch.bfloat16 if c.dtype == "bfloat16" else torch.float32


def _weight(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    return weight * h.to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float,
                dtype: torch.dtype):
    """(cos, sin) [R, L, 1, dim] in ``dtype`` at ``positions`` [R, L]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek's RoPE: the interleaved pairs regrouped as halves, then
    x cos + rotate_half(x) sin."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def causal_segment_bias(segment_ids: torch.Tensor) -> torch.Tensor:
    """[R, L, L] fp32 additive bias: query t sees key j of its own segment
    (>= 1) with j <= t; every other key gets ``ATTN_MASK_BIAS``, an exact
    zero after the max-subtracted fp32 softmax."""
    L = segment_ids.shape[-1]
    valid = segment_ids > 0
    same = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (
        valid[:, None, :])
    pos = torch.arange(L, device=segment_ids.device)
    causal = pos[:, None] >= pos[None, :]
    return (~(same & causal)).float() * ATTN_MASK_BIAS


class Attention(nn.Module):
    """Multi-head latent attention without query compression."""

    def __init__(self, c: MoonlightConfig, dtype: torch.dtype):
        super().__init__()
        self.c = c
        H, D = c.num_attention_heads, c.hidden_size
        self.q_proj = _weight(H * c.q_head_dim, D, dtype=dtype)
        self.kv_a_proj_with_mqa = _weight(c.kv_lora_rank + c.qk_rope_head_dim,
                                          D, dtype=dtype)
        self.kv_a_layernorm = _weight(c.kv_lora_rank, dtype=dtype)
        self.kv_b_proj = _weight(H * (c.qk_nope_head_dim + c.v_head_dim),
                                 c.kv_lora_rank, dtype=dtype)
        self.o_proj = _weight(D, H * c.v_head_dim, dtype=dtype)

    def forward(self, x, bias, cos, sin):
        c = self.c
        R, L, _ = x.shape
        H, dn, dr, dv = (c.num_attention_heads, c.qk_nope_head_dim,
                         c.qk_rope_head_dim, c.v_head_dim)
        q = F.linear(x, self.q_proj).view(R, L, H, dn + dr)
        latent, k_pe = F.linear(x, self.kv_a_proj_with_mqa).split(
            [c.kv_lora_rank, dr], dim=-1)
        kv = F.linear(rms_norm(latent, self.kv_a_layernorm, c.rms_norm_eps),
                      self.kv_b_proj).view(R, L, H, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q_pe = apply_rope(q[..., dn:], cos, sin)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
        q = torch.cat([q[..., :dn], q_pe], dim=-1).reshape(R, L, H * (dn + dr))
        k = torch.cat([k_nope, k_pe.expand(R, L, H, dr)], dim=-1).reshape(
            R, L, H * (dn + dr))
        v = v.reshape(R, L, H * dv)
        o = fused_attention(q, k, v, bias, H, scale=c.q_head_dim ** -0.5)
        return F.linear(o, self.o_proj)


class MLP(nn.Module):
    """down(silu(gate x) * up x), in the compute type."""

    def __init__(self, hidden: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = _weight(width, hidden, dtype=dtype)
        self.up_proj = _weight(width, hidden, dtype=dtype)
        self.down_proj = _weight(hidden, width, dtype=dtype)

    def forward(self, x):
        return F.linear(moe.swiglu_plain(F.linear(x, self.gate_proj),
                                         F.linear(x, self.up_proj)),
                        self.down_proj)


class MoE(nn.Module):
    """The sigmoid router with its correction bias, the routed experts
    (stacked) and the shared experts."""

    def __init__(self, c: MoonlightConfig, dtype: torch.dtype):
        super().__init__()
        self.c = c
        E, D, W = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate = _weight(E, D, dtype=dtype)
        self.e_score_correction_bias = _weight(E, dtype=dtype)
        self.experts_gate_up = _weight(E, 2 * W, D, dtype=dtype)
        self.experts_down = _weight(E, D, W, dtype=dtype)
        if c.n_shared_experts:
            self.shared_experts = MLP(D, c.n_shared_experts * W, dtype)

    def forward(self, y, residual, load=None):
        """(residual + the layer's output, the chosen experts [T, k])."""
        c = self.c
        shape = y.shape
        x = y.reshape(-1, shape[-1])
        logits = F.linear(x.float(), self.gate.float())
        shared = self.shared_experts(x) if c.n_shared_experts else None
        out, idx = moe.experts(
            x, logits, self.e_score_correction_bias, c.num_experts_per_tok,
            c.routed_scaling_factor, self.experts_gate_up, self.experts_down,
            shared, residual.reshape(-1, shape[-1]), load)
        return out.view(shape), idx


class DecoderLayer(nn.Module):
    def __init__(self, c: MoonlightConfig, dense: bool, dtype: torch.dtype):
        super().__init__()
        self.c = c
        self.dense = dense
        self.input_layernorm = _weight(c.hidden_size, dtype=dtype)
        self.self_attn = Attention(c, dtype)
        self.post_attention_layernorm = _weight(c.hidden_size, dtype=dtype)
        self.mlp = (MLP(c.hidden_size, c.intermediate_size, dtype) if dense
                    else MoE(c, dtype))

    def forward(self, x, bias, cos, sin, load=None):
        eps = self.c.rms_norm_eps
        h = x + self.self_attn(rms_norm(x, self.input_layernorm, eps), bias,
                               cos, sin)
        y = rms_norm(h, self.post_attention_layernorm, eps)
        if self.dense:
            return h + self.mlp(y), None
        return self.mlp(y, h, load)


class MoonlightModel(nn.Module):
    def __init__(self, c: MoonlightConfig):
        super().__init__()
        self.config = c
        self.dtype = compute_dtype(c)
        self.embed_tokens = _weight(c.vocab_size, c.hidden_size,
                                    dtype=self.dtype)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                c, i < c.first_k_dense_replace, self.dtype))
        self.norm = _weight(c.hidden_size, dtype=self.dtype)
        self.register_buffer(
            "expert_load",
            torch.zeros(c.moe_layers, c.n_routed_experts, dtype=torch.int64),
            persistent=False)
        self.routes: Optional[List[torch.Tensor]] = None

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                combine_weights=None, segment_ids=None, position_ids=None,
                stop_layer_gradients: bool = False):
        """``BertModel.forward``'s contract: without ``combine_weights``
        (all layers [n_layers, R, L, D] fp32, None); with them (the
        weighted layer sum [R, L, D] fp32, None). ``token_type_ids`` is
        not read (the model has no segment embedding)."""
        del token_type_ids
        c = self.config
        R, L = input_ids.shape
        if L > MAX_LEN:
            raise ValueError(f"Moonlight encoder: rows of {L} tokens exceed "
                             f"the attention kernel's {MAX_LEN}")
        if segment_ids is None:
            segment_ids = (torch.ones_like(input_ids) if attention_mask is None
                           else attention_mask.long())
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device)[None].expand(
                R, L)
        bias = causal_segment_bias(segment_ids)
        cos, sin = rope_tables(position_ids, c.qk_rope_head_dim, c.rope_theta,
                               self.dtype)
        encoder_grad = torch.is_grad_enabled() and not stop_layer_gradients
        layers, acc = [], None
        with torch.set_grad_enabled(encoder_grad):
            x = F.embedding(input_ids, self.embed_tokens)
        last = c.num_hidden_layers - 1
        for i in range(c.num_hidden_layers):
            with torch.set_grad_enabled(encoder_grad):
                layer = getattr(self, f"layer_{i}")
                j = i - c.first_k_dense_replace
                x, idx = layer(x, bias, cos, sin,
                               None if layer.dense else self.expert_load[j])
                out = (rms_norm(x, self.norm, c.rms_norm_eps) if i == last
                       else x).float()
            if idx is not None and self.routes is not None:
                self.routes.append(idx)
            if combine_weights is None:
                layers.append(out)
            else:
                term = combine_weights[i] * out
                acc = term if acc is None else acc + term
        if combine_weights is None:
            return torch.stack(layers, dim=0), None
        return acc, None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoonlightModel":
        """Random weights from ``generator`` (on the parameters' device), in
        the order of the sorted names: every matrix and the embedding
        N(0, initializer_range), the norms 1, the correction biases 0."""
        std = self.config.initializer_range
        for name, p in sorted(self.named_parameters()):
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith("e_score_correction_bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def cache_compute_weights(self) -> "MoonlightModel":
        """A no-op: the weights are held in the compute type."""
        return self
