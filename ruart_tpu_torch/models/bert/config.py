"""BERT configuration (compatible with bert_config.json files).

Field names match the Google/HF ``bert_config.json`` schema (reference
`Models/Bert/modeling.py:67-153`). Copy of ``ruart_tpu/models/bert/config.py``.
``dtype`` is the encoder's compute type
(fp32, or bf16 under the ``BF16`` conf key; the weights stay fp32 either
way); ``quant='int8'`` makes the projection weights weight-only int8."""

from __future__ import annotations

import dataclasses
import json

ATTENTION_IMPLS = ("auto", "plain")
DTYPES = ("float32", "bfloat16")
QUANT_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    # 'auto': the hand-written CUDA attention kernel for CUDA tensors, its
    # plain PyTorch version for CPU tensors (ops/attention.py). 'plain'
    # forces the plain version on any device — the comparison arm only.
    attention_impl: str = "auto"
    # compute type of the encoder layers ('bfloat16': the BF16 conf key)
    dtype: str = "float32"
    # 'int8': weight-only int8 projection/FFN layers (ops/quant.py; the
    # INT8_BERT serving mode), weights from quant.quantize_bert_params
    quant: str = "none"
    # (dp, tp) rank mesh (parallel.mesh.Mesh) for multi-rank execution:
    # each rank holds its tp shard of the projections and FFN (as
    # parallel.mesh._PARAM_RULES lays them out) and runs the attention
    # kernel on its local heads (ops.attention.sharded_fused_attention).
    # None = one rank.
    mesh: object = None

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {self.attention_impl!r} not in {ATTENTION_IMPLS}"
            )
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {DTYPES}")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r} not in {QUANT_MODES}")

    @classmethod
    def large_uncased(cls, **kw) -> "BertConfig":
        return cls(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            **kw,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256, **kw) -> "BertConfig":
        """Small config for tests."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=32,
            num_hidden_layers=3,
            num_attention_heads=4,
            intermediate_size=64,
            **kw,
        )

    @classmethod
    def from_json(cls, path: str, **overrides) -> "BertConfig":
        """A ``bert_config.json`` (unknown keys ignored) plus overrides."""
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in fields}
        kw.update(overrides)
        return cls(**kw)
