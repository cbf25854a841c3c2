"""The Moonlight-16B-A3B text encoder (DeepSeek-V3 architecture,
https://huggingface.co/moonshotai/Moonlight-16B-A3B) in plain ``torch``
float32: the reference the port's ``ruart_tpu_torch/models/moonlight`` is
held to. It imports no kernel of the port and no JAX.

Per layer, from x0 = E[ids]: h = x + MLA(RMSNorm(x)), x' = h +
FFN(RMSNorm(h)); the FFN is a SwiGLU of ``intermediate_size`` in the first
``first_k_dense_replace`` layers and the expert layer after them.

* MLA, no query compression: q = W_q x, heads of [q_nope | q_pe];
  [c_kv | k_pe] = W_kva x; c_kv <- RMSNorm(c_kv); [k_nope | v] per head =
  W_kvb c_kv; k_pe one rope key for all heads; RoPE with theta
  ``rope_theta`` in DeepSeek's interleaved-pair layout at each token's
  position within its own segment; scores [q_nope | q_pe] . [k_nope | k_pe]
  / sqrt(nope + rope); causal within each packed segment; o = W_o (heads
  of P v).
* Experts: s = sigmoid(W_g x); the top k of s + ``e_score_correction_bias``
  (the bias chooses only); w = s_sel / (sum s_sel + 1e-20) *
  ``routed_scaling_factor``; y = sum_k w_k W_down,k (silu(W_gate,k x) *
  W_up,k x) + the shared experts' SwiGLU (width n_shared x
  ``moe_intermediate_size``).
* RMSNorm: x / sqrt(mean(x^2) + eps) * weight.
* What RUArt reads: the layer outputs as the published model's
  ``hidden_states[1:]`` (the last after the final norm), mixed by the
  α-combine weights.

Departures from the published modelling code (``modeling_deepseek.py``):
no LM head (RUArt reads hidden states); float32 throughout (the published
model runs in bf16), from the weight values as given (bf16 on the card,
widened one layer at a time as the layer runs, so the reference fits
beside the fusion model); the experts computed as a loop over experts
with index_select (the published inference loop, without its sort). A
packed row's causal mask per segment is the published causal mask for
each sequence, not a departure.

``fault`` (None in the reference proper) puts a control or a planted
fault in place, for the runs that set the cell's limits: ``fp8`` (the
routed experts' weights and inputs rounded to fp8 e4m3 with a per-tensor
(weights: per expert; inputs: per row) scale, a precision below the
configuration's bf16), ``top5`` (one expert fewer than ``num_experts_per_tok``),
``nobias`` (the correction bias left out of the selection), ``nocausal``
(the causal mask dropped; segments still kept apart).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

ATTN_MASK_BIAS = -10000.0
FAULTS = ("fp8", "top5", "nobias", "nocausal")
FP8_MAX = 448.0   # the largest finite float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    initializer_range: float = 0.02
    # read by the reference's ModelSpec (BF16, INT8_BERT); the reference
    # computes in fp32 whatever they say
    dtype: str = "float32"
    quant: str = "none"

    @classmethod
    def from_dict(cls, raw: dict) -> "MoonlightConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    @classmethod
    def from_json(cls, path: str) -> "MoonlightConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _weight(*shape, dtype):
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight.float()


def rope(x, positions, theta):
    """DeepSeek's RoPE on x [R, L, h, d] at ``positions`` [R, L]: the
    interleaved pairs regrouped as halves, x cos + rotate_half(x) sin."""
    R, L, h, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
    x = x.reshape(R, L, h, d // 2, 2).transpose(-1, -2).reshape(R, L, h, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def to_fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with an amax scale (over the whole tensor,
    or per slice along ``dim``), back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = (amax / FP8_MAX).clamp(min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Attention(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        self.c = c
        H, D = c.num_attention_heads, c.hidden_size
        dq = c.qk_nope_head_dim + c.qk_rope_head_dim
        self.q_proj = _weight(H * dq, D, dtype=dtype)
        self.kv_a_proj_with_mqa = _weight(c.kv_lora_rank + c.qk_rope_head_dim,
                                          D, dtype=dtype)
        self.kv_a_layernorm = _weight(c.kv_lora_rank, dtype=dtype)
        self.kv_b_proj = _weight(H * (c.qk_nope_head_dim + c.v_head_dim),
                                 c.kv_lora_rank, dtype=dtype)
        self.o_proj = _weight(D, H * c.v_head_dim, dtype=dtype)

    def forward(self, x, mask, positions):
        c = self.c
        R, L, _ = x.shape
        H, dn, dr, dv = (c.num_attention_heads, c.qk_nope_head_dim,
                         c.qk_rope_head_dim, c.v_head_dim)
        q = F.linear(x, self.q_proj.float()).view(R, L, H, dn + dr)
        latent, k_pe = F.linear(x, self.kv_a_proj_with_mqa.float()).split(
            [c.kv_lora_rank, dr], dim=-1)
        kv = F.linear(rms_norm(latent, self.kv_a_layernorm, c.rms_norm_eps),
                      self.kv_b_proj.float()).view(R, L, H, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, c.rope_theta)],
                      dim=-1)
        k_pe = rope(k_pe[:, :, None, :], positions, c.rope_theta)
        k = torch.cat([k_nope, k_pe.expand(R, L, H, dr)], dim=-1)
        s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(dn + dr)
        s = s + mask[:, None]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhlm,bmhd->blhd", p, v).reshape(R, L, H * dv)
        return F.linear(o, self.o_proj.float())


class MLP(nn.Module):
    def __init__(self, hidden, width, dtype):
        super().__init__()
        self.gate_proj = _weight(width, hidden, dtype=dtype)
        self.up_proj = _weight(width, hidden, dtype=dtype)
        self.down_proj = _weight(hidden, width, dtype=dtype)

    def forward(self, x):
        return F.linear(F.silu(F.linear(x, self.gate_proj.float()))
                        * F.linear(x, self.up_proj.float()),
                        self.down_proj.float())


class MoE(nn.Module):
    def __init__(self, c, dtype):
        super().__init__()
        self.c = c
        E, D, W = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.gate = _weight(E, D, dtype=dtype)
        self.e_score_correction_bias = _weight(E, dtype=dtype)
        self.experts_gate_up = _weight(E, 2 * W, D, dtype=dtype)
        self.experts_down = _weight(E, D, W, dtype=dtype)
        if c.n_shared_experts:
            self.shared_experts = MLP(D, c.n_shared_experts * W, dtype)

    def forward(self, y, fault=None):
        """(the layer's FFN output [..., D], the chosen experts [T, k])."""
        c = self.c
        shape = y.shape
        x = y.reshape(-1, shape[-1])
        T, W = x.shape[0], c.moe_intermediate_size
        scores = torch.sigmoid(F.linear(x, self.gate.float()))
        choice = scores if fault == "nobias" else (
            scores + self.e_score_correction_bias.float())
        k = c.num_experts_per_tok - (fault == "top5")
        _, idx = torch.topk(choice, k, dim=-1)
        w = scores.gather(1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * c.routed_scaling_factor
        slots = x.new_zeros(T, k, shape[-1])
        for e in range(c.n_routed_experts):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            gu = self.experts_gate_up[e].float()
            down = self.experts_down[e].float()
            xe = x.index_select(0, tok)
            if fault == "fp8":
                gu, down, xe = to_fp8(gu, None), to_fp8(down, None), to_fp8(xe, 1)
            h = F.linear(xe, gu)
            a = F.silu(h[:, :W]) * h[:, W:]
            if fault == "fp8":
                a = to_fp8(a, 1)
            slots[tok, slot] = F.linear(a, down) * w[tok, slot, None]
        out = slots.sum(1)
        if c.n_shared_experts:
            out = out + self.shared_experts(x)
        return out.view(shape), idx


class DecoderLayer(nn.Module):
    def __init__(self, c, dense, dtype):
        super().__init__()
        self.c = c
        self.dense = dense
        self.input_layernorm = _weight(c.hidden_size, dtype=dtype)
        self.self_attn = Attention(c, dtype)
        self.post_attention_layernorm = _weight(c.hidden_size, dtype=dtype)
        self.mlp = (MLP(c.hidden_size, c.intermediate_size, dtype) if dense
                    else MoE(c, dtype))

    def forward(self, x, mask, positions, fault=None):
        eps = self.c.rms_norm_eps
        h = x + self.self_attn(rms_norm(x, self.input_layernorm, eps), mask,
                               positions)
        y = rms_norm(h, self.post_attention_layernorm, eps)
        if self.dense:
            return h + self.mlp(y), None
        out, idx = self.mlp(y, fault)
        return h + out, idx


def segment_mask(segment_ids, causal=True):
    """[R, L, L] additive mask: a token sees the earlier tokens (and itself)
    of its own segment (>= 1); with ``causal`` False, its whole segment."""
    L = segment_ids.shape[-1]
    valid = segment_ids > 0
    ok = (segment_ids[:, :, None] == segment_ids[:, None, :]) & valid[:, None, :]
    if causal:
        pos = torch.arange(L, device=segment_ids.device)
        ok = ok & (pos[:, None] >= pos[None, :])
    return (~ok).float() * ATTN_MASK_BIAS


class MoonlightEncoder(nn.Module):
    """The encoder with ``BertModel``'s call: (the α-combined layers, or
    all layers [n, R, L, D], and None)."""

    def __init__(self, c: MoonlightConfig, dtype=torch.float32):
        super().__init__()
        self.config = c
        self.embed_tokens = _weight(c.vocab_size, c.hidden_size, dtype=dtype)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                c, i < c.first_k_dense_replace, dtype))
        self.norm = _weight(c.hidden_size, dtype=dtype)
        self.fault: Optional[str] = None
        self.routes: Optional[List[torch.Tensor]] = None

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                combine_weights=None, segment_ids=None, position_ids=None,
                stop_layer_gradients=False):
        c = self.config
        R, L = input_ids.shape
        if segment_ids is None:
            segment_ids = (torch.ones_like(input_ids) if attention_mask is None
                           else attention_mask.long())
        if position_ids is None:
            position_ids = torch.arange(L, device=input_ids.device)[None].expand(
                R, L)
        mask = segment_mask(segment_ids, causal=self.fault != "nocausal")
        grad = torch.is_grad_enabled() and not stop_layer_gradients
        layers, acc = [], None
        with torch.set_grad_enabled(grad):
            x = F.embedding(input_ids, self.embed_tokens).float()
        for i in range(c.num_hidden_layers):
            with torch.set_grad_enabled(grad):
                x, idx = getattr(self, f"layer_{i}")(x, mask, position_ids,
                                                     self.fault)
                out = (rms_norm(x, self.norm, c.rms_norm_eps)
                       if i == c.num_hidden_layers - 1 else x)
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


@contextlib.contextmanager
def _encoder_as_bert(dtype):
    """The reference RUArtModel's module, building this encoder (weights in
    ``dtype``) in BERT's slot inside the block."""
    from portbench.reference import model as ref_model

    orig = ref_model.BertModel
    ref_model.BertModel = functools.partial(MoonlightEncoder, dtype=dtype)
    try:
        yield ref_model
    finally:
        ref_model.BertModel = orig


def ruart_model(spec, dtype=torch.float32):
    """The reference ``RUArtModel`` of ``spec`` (its ``bert`` a
    :class:`MoonlightConfig`), the encoder's weights held in ``dtype``."""
    with _encoder_as_bert(dtype) as ref_model:
        return ref_model.RUArtModel(spec)
