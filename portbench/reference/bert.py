"""BERT encoder in PyTorch — port of ``ruart_tpu/models/bert/model.py``.

The 2018 BERT architecture the reference vendors
(`Models/Bert/modeling.py:155-614`), with the JAX package's structure:

* the encoder returns every layer's activations, or — given
  ``combine_weights`` — their weighted sum accumulated in the layer loop
  (the fusion model's α-combine, `SDNet.py:573-583`);
* attention runs through ``ops.attention.fused_attention`` on [B, L, H*dh]
  projections: the hand-written CUDA kernel for CUDA tensors, its plain
  version on the CPU, with a backward that recomputes through the plain
  version (``attention_impl='plain'`` forces the plain version anywhere);
* ``stop_layer_gradients`` (LOCK_BERT) cuts every layer's output from the
  graph while the combine weights stay in it;
* ``quant='int8'`` builds the six projection/FFN layers of each encoder
  layer as weight-only int8 ``ops.quant.QuantLinear`` (INT8_BERT);
* ``dtype='bfloat16'`` (BF16) computes the encoder layers in bf16 as the
  JAX package does: the embeddings are layer-normed in fp32 and cast; the
  six Linears (product rounded to bf16, then the bf16 bias added), the
  gelu (:func:`gelu`) and the attention take and give bf16 (fp32 sums);
  each LayerNorm takes its statistics and affine in fp32 and rounds once;
  every layer's output is widened to fp32 before the α-combine and the
  pooler, which stays fp32. The weights stay fp32: a Linear casts its
  weight per call, as flax does, unless
  :meth:`BertModel.cache_compute_weights` made the frozen encoder one copy
  in the compute type;
* subword→word pooling is a batched segment-mean matmul
  (:func:`subword_to_word_pooling`); :class:`BertWordEncoder` is the
  encoder, the α-combine and the pooling in one module, and
  :func:`encode_chunked` encodes sequences over 512 in chunks;
* with a (dp, tp) rank mesh in ``BertConfig.mesh``, each rank holds its tp
  shard of the layers ``parallel.mesh._PARAM_RULES`` shards: Q/K/V and
  ``intermediate_dense`` are column-parallel (this rank's heads and hidden
  units), ``attention_output_dense`` and ``output_dense`` row-parallel
  (:class:`RowParallelLinear`: partial products summed over tp, in the
  layer's output type — bf16 under BF16, as the JAX program reduces the
  Dense output — then the bias added once), ``word_embeddings``
  vocab-parallel; the attention runs the kernel on the local heads
  (``ops.attention.sharded_fused_attention``). A rule tp does not divide
  leaves its layer whole (``parallel.mesh.param_dim``). Under ``quant='int8'``
  the six projection/FFN layers stay whole on every rank, as the JAX mesh
  rules leave ``kernel_q`` replicated, and the attention runs the kernel
  over all heads; the word table is still split.

Module and parameter names follow the flax tree (``embeddings``,
``layer_<i>``, ``attention_self.query`` ...) so ``convert.from_jax_params``
maps each flax leaf to one entry of the state dict. The encoder runs
without dropout in training too, as the reference runs BERT in eval
mode (`Bert.py:43`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.bert_config import BertConfig
from portbench.reference.plain import (
    attention_rows_plain,
    fused_attention,
    sharded_fused_attention,
)
from portbench.reference.plain import QuantLinear
from portbench.reference.plain import (
    all_reduce,
    mark_sharded,
    vocab_embedding,
)
from portbench.reference.plain import param_dim

ATTN_MASK_BIAS = -10000.0  # reference `modeling.py:583`


def compute_dtype(c: BertConfig) -> torch.dtype:
    return torch.bfloat16 if c.dtype == "bfloat16" else torch.float32


class Linear(nn.Linear):
    """``nn.Linear`` in its input's type (flax ``nn.Dense(dtype=...)`` over
    fp32 parameters): a bf16 input takes the weight and bias cast to bf16,
    from ``compute_copy`` when one was made for that type."""

    compute_copy = None  # (weight, bias) in a compute type, or None

    def typed(self, x: torch.Tensor):
        """(weight, bias) in ``x``'s type."""
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            copy = self.compute_copy
            if copy is not None and copy[0].dtype == x.dtype:
                w, b = copy
            else:
                w, b = w.to(x.dtype), b.to(x.dtype)
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *self.typed(x))


class RowParallelLinear(Linear):
    """This rank's input-feature shard of a Linear: the partial product,
    summed over the tp group in its output type, then the (replicated)
    bias added once."""

    def __init__(self, in_features: int, out_features: int, group):
        super().__init__(in_features, out_features)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.typed(x)
        return all_reduce(F.linear(x, w), self.group) + b


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose statistics and affine run in fp32 whatever the
    input's type, rounded once to it (flax's LayerNorm over fp32
    parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def _sharded_dim(c: BertConfig, name: str, shape) -> Optional[int]:
    """The dim of the encoder parameter ``name`` (full ``shape``) that this
    config's mesh shards over tp, or None."""
    if c.mesh is None:
        return None
    return param_dim("Bert." + name, shape, c.mesh.tp, c.num_attention_heads)


def _dense(c: BertConfig, in_features: int, out_features: int,
           name: str = "") -> nn.Module:
    """Linear factory for the encoder's projection/FFN layers: :class:`Linear`
    normally, weight-only-int8 :class:`QuantLinear` when ``c.quant ==
    'int8'`` (weights converted by ``ops.quant.quantize_bert_params``).
    Under a mesh, the layer ``name`` (e.g. ``layer_0.output_dense``) holds
    its tp shard: its output features (column-parallel) or its input
    features (:class:`RowParallelLinear`). An int8 layer stays whole on
    every rank, bias included: the JAX package's mesh rules match
    ``kernel`` and never ``kernel_q``/``scale``, so its int8 projections
    are replicated (``parallel.mesh.param_shardings`` keeps them so)."""
    if c.quant == "int8":
        return QuantLinear(in_features, out_features)
    dim = _sharded_dim(c, name + ".weight", (out_features, in_features))
    if dim == 0:
        return mark_sharded(Linear(in_features, out_features // c.mesh.tp),
                            weight=0, bias=0)
    if dim == 1:
        return mark_sharded(RowParallelLinear(
            in_features // c.mesh.tp, out_features, c.mesh.tp_group), weight=1)
    return Linear(in_features, out_features)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = vocab_embedding(
            c.vocab_size, c.hidden_size,
            _sharded_dim(c, "embeddings.word_embeddings.weight",
                         (c.vocab_size, c.hidden_size)),
            c.mesh,
        )
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size
        )
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size
        )
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.dtype = compute_dtype(c)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[-1], device=input_ids.device
            )[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(token_type_ids)
        )
        return self.LayerNorm(x).to(self.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, prefix: str = "layer_0"):
        super().__init__()
        D = c.hidden_size
        self.heads = c.num_attention_heads
        self.impl = c.attention_impl
        self.query = _dense(c, D, D, f"{prefix}.attention_self.query")
        self.key = _dense(c, D, D, f"{prefix}.attention_self.key")
        self.value = _dense(c, D, D, f"{prefix}.attention_self.value")
        # the mesh when the projections hold this rank's heads only
        self.mesh = c.mesh if self.query.out_features < D else None

    def forward(self, hidden, bias):
        """``bias``: float32 [B, L] key bias or [B, L, L] per-query bias;
        q/k/v and the output in the compute type of ``hidden``. Under a
        mesh that shards the heads, q/k/v and the output hold this rank's
        heads."""
        q, k, v = self.query(hidden), self.key(hidden), self.value(hidden)
        plain = self.impl == "plain"
        if self.mesh is not None:
            return sharded_fused_attention(q, k, v, bias, self.heads,
                                           self.mesh, plain=plain)
        attend = attention_rows_plain if plain else fused_attention
        return attend(q, k, v, bias, self.heads)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, prefix: str = "layer_0"):
        super().__init__()
        D = c.hidden_size
        self.attention_self = BertSelfAttention(c, prefix)
        self.attention_output_dense = _dense(
            c, D, D, f"{prefix}.attention_output_dense")
        self.attention_output_LayerNorm = LayerNorm(D, eps=c.layer_norm_eps)
        self.intermediate_dense = _dense(
            c, D, c.intermediate_size, f"{prefix}.intermediate_dense")
        self.output_dense = _dense(
            c, c.intermediate_size, D, f"{prefix}.output_dense")
        self.output_LayerNorm = LayerNorm(D, eps=c.layer_norm_eps)

    def forward(self, hidden, bias):
        attn = self.attention_output_dense(self.attention_self(hidden, bias))
        hidden = self.attention_output_LayerNorm(attn + hidden)
        inter = gelu(self.intermediate_dense(hidden))
        return self.output_LayerNorm(self.output_dense(inter) + hidden)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The erf form of gelu. In bf16 it is written as the JAX package's
    ``jax.nn.gelu(approximate=False)`` lowers: 0.5·x·erfc(−x·0.70703125)
    (1/sqrt(2) rounded to bf16), each op rounding to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.special.erfc(x * -0.70703125)


def attention_bias(
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The additive attention bias in the kernel's layout.

    With ``segment_ids`` [B, L] (0 = pad, >= 1 = packed segment): the
    block-diagonal [B, L, L] form — query t attends only keys of its own
    segment; cross-segment and pad keys get ``ATTN_MASK_BIAS``, which
    underflows to an exact zero after the max-subtracted fp32 softmax, so a
    packed segment's outputs equal the same sequence encoded alone.
    Otherwise the [B, L] key form from ``attention_mask`` (all ones when
    None)."""
    if segment_ids is not None:
        valid = segment_ids > 0
        same = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (
            valid[:, None, :]
        )
        return (1.0 - same.float()) * ATTN_MASK_BIAS
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    return (1.0 - attention_mask.float()) * ATTN_MASK_BIAS


class BertModel(nn.Module):
    """All encoder layers plus the pooled [CLS] vector (reference
    `modeling.py:534-614` with output_all_encoded_layers=True)."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.config = c
        self.embeddings = BertEmbeddings(c)
        for i in range(c.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(c, f"layer_{i}"))
        self.pooler_dense = Linear(c.hidden_size, c.hidden_size)

    def forward(
        self,
        input_ids,
        attention_mask=None,
        token_type_ids=None,
        combine_weights=None,
        segment_ids=None,
        position_ids=None,
        stop_layer_gradients: bool = False,
    ):
        """Without ``combine_weights``: (all_layers [n_layers, B, L, D],
        pooled [B, D]). With ``combine_weights`` [n_layers]: (the weighted
        layer sum [B, L, D], pooled) — accumulated in the loop, so the
        stack is never held. See :func:`attention_bias` for the two mask
        forms. ``stop_layer_gradients`` runs the encoder without a graph
        (the JAX package's ``stop_gradient`` on every layer output), so no
        gradient reaches its parameters while ``combine_weights`` still
        gets one."""
        bias = attention_bias(input_ids, attention_mask, segment_ids)
        encoder_grad = torch.is_grad_enabled() and not stop_layer_gradients
        with torch.set_grad_enabled(encoder_grad):
            hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        layers = []
        acc = None
        for i in range(self.config.num_hidden_layers):
            with torch.set_grad_enabled(encoder_grad):
                hidden = getattr(self, f"layer_{i}")(hidden, bias)
                out = hidden.float()
            if combine_weights is None:
                layers.append(out)
            else:
                term = combine_weights[i] * out
                acc = term if acc is None else acc + term
        with torch.set_grad_enabled(encoder_grad):
            pooled = torch.tanh(self.pooler_dense(out[:, 0]))
        if combine_weights is None:
            return torch.stack(layers, dim=0), pooled
        return acc, pooled

    @torch.no_grad()
    def cache_compute_weights(self) -> "BertModel":
        """Give each projection/FFN :class:`Linear` one copy of its weight
        and bias in the compute type, made now, so that a bf16 forward
        casts nothing per call (72 Linears at BERT-base: 144 casts per
        forward saved). For frozen weights only — an engine's: the copy does
        not follow later changes to the parameters. A no-op in fp32."""
        dtype = compute_dtype(self.config)
        if dtype == torch.float32:
            return self
        for name, mod in self.named_modules():
            if isinstance(mod, Linear) and not name.startswith("pooler"):
                mod.compute_copy = (mod.weight.detach().to(dtype),
                                    mod.bias.detach().to(dtype))
        return self


def encode_chunked(model: BertModel, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, max_chunk: int = 512
                   ) -> torch.Tensor:
    """Reference >512 chunking (`Bert.py:94-101`): encode fixed chunks of
    ``max_chunk`` positions one after the other (positions restart in each
    chunk) and join every layer's outputs on the sequence axis: [n_layers,
    B, L, D]."""
    L = input_ids.shape[-1]
    if L <= max_chunk:
        return model(input_ids, attention_mask)[0]
    outs = []
    for p in range(0, L, max_chunk):
        sl = slice(p, min(p + max_chunk, L))
        outs.append(model(input_ids[:, sl], attention_mask[:, sl])[0])
    return torch.cat(outs, dim=2)


def subword_to_word_pooling(
    bert_embedding: torch.Tensor,
    offsets: torch.Tensor,
    word_mask: torch.Tensor,
) -> torch.Tensor:
    """Mean-pool wordpiece spans into word vectors as one matmul.

    bert_embedding: [..., B, Lb, D] (leading layer axis allowed)
    offsets:        [B, W, 2] (start, end) piece spans per word
    word_mask:      [B, W] 1 = real word

    As `Bert.py:111-123`: a span of length <= 1 (empty included) takes the
    vector at ``start``; longer spans take the mean over [start, end);
    masked words are zero.
    """
    Lb = bert_embedding.shape[-2]
    st = offsets[..., 0]
    ed = offsets[..., 1]
    span = ed - st
    kk = torch.arange(Lb, device=offsets.device)[None, None, :]
    in_span = (kk >= st[..., None]) & (kk < ed[..., None])          # [B, W, Lb]
    single = span <= 1
    onehot = kk == st.clamp(0, Lb - 1)[..., None]
    weights = torch.where(
        single[..., None],
        onehot.float(),
        in_span.float() / span.clamp(min=1)[..., None].float(),
    )
    weights = weights * word_mask[..., None].float()
    return torch.matmul(weights, bert_embedding)


def linear_combine(all_layers: torch.Tensor, alpha: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """α-softmax layer mix: sum_l softmax(α)_l * gamma * layer_l
    (`SDNet.py:573-583`). all_layers: [n_layers, ...]; returns [...]."""
    w = torch.softmax(alpha, dim=0) * gamma.reshape(())
    return torch.tensordot(w, all_layers, dims=([0], [0]))


class BertWordEncoder(nn.Module):
    """BERT + word pooling + 12-layer linear combine in one module.

    Combining layers BEFORE pooling is mathematically identical to the
    reference's pool-then-combine (both are linear) and 12x cheaper on the
    pooling matmul. Parameters as the flax module's: ``bert``, and
    ``alphaBERT`` [n_layers] / ``gammaBERT`` [1, 1] with the combine.
    """

    def __init__(self, config: BertConfig, linear_combine: bool = True):
        super().__init__()
        self.config = config
        self.linear_combine = linear_combine
        self.bert = BertModel(config)
        if linear_combine:
            self.alphaBERT = nn.Parameter(torch.ones(config.num_hidden_layers))
            self.gammaBERT = nn.Parameter(torch.ones(1, 1))

    def forward(self, input_ids, attention_mask, offsets, word_mask):
        if self.linear_combine:
            w = torch.softmax(self.alphaBERT, dim=0) * self.gammaBERT.reshape(())
            combined, _ = self.bert(input_ids, attention_mask,
                                    combine_weights=w)
        else:
            all_layers, _ = self.bert(input_ids, attention_mask)
            combined = all_layers[-1]
        return subword_to_word_pooling(combined, offsets, word_mask)
