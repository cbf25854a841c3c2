"""Configuration of the Moonlight-16B-A3B text encoder (the DeepSeek-V3
architecture, ``model_type`` deepseek_v3), read from its published
``config.json`` (https://huggingface.co/moonshotai/Moonlight-16B-A3B).

Field names follow that file; keys it has and this encoder does not read
are ignored, and the settings the encoder does not implement are refused
(:meth:`MoonlightConfig.__post_init__`): query compression
(``q_lora_rank``), grouped routing (``n_group`` > 1), another scoring or
selection method, ``rope_scaling``, attention biases. ``dtype`` is the
encoder's compute and storage type (bf16 under the ``BF16`` conf key: the
weights are held in bf16 alone). The fusion model reaches it through the
conf key ``LLM_ENCODER <path to config.json>``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

DTYPES = ("float32", "bfloat16")


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
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    rope_theta: float = 50000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    hidden_act: str = "silu"
    attention_bias: bool = False
    model_type: str = "deepseek_v3"
    # not in the published file: the std of init_weights' normal draws
    initializer_range: float = 0.02
    dtype: str = "float32"
    # the BERT encoder's int8 mode (INT8_BERT), which this encoder does not
    # have; read where the trainer and the engine ask for it
    quant: str = "none"

    def __post_init__(self):
        refusals = (
            (self.model_type == "deepseek_v3",
             f"model_type {self.model_type!r}"),
            (self.q_lora_rank is None, "q_lora_rank (query compression)"),
            (self.n_group == 1 and self.topk_group == 1,
             "grouped routing (n_group / topk_group over 1)"),
            (self.scoring_func == "sigmoid",
             f"scoring_func {self.scoring_func!r}"),
            (self.topk_method == "noaux_tc",
             f"topk_method {self.topk_method!r}"),
            (self.rope_scaling is None, "rope_scaling"),
            (self.hidden_act == "silu", f"hidden_act {self.hidden_act!r}"),
            (not self.attention_bias, "attention_bias"),
            (self.moe_layer_freq == 1, "moe_layer_freq over 1"),
            (self.norm_topk_prob, "norm_topk_prob false"),
            (self.dtype in DTYPES, f"dtype {self.dtype!r}"),
            (self.quant == "none", "INT8_BERT (int8 weights)"),
        )
        bad = [what for ok, what in refusals if not ok]
        if bad:
            raise ValueError("the Moonlight encoder does not implement "
                             + ", ".join(bad))

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @classmethod
    def from_json(cls, path: str, **overrides) -> "MoonlightConfig":
        """A published ``config.json`` (unknown keys ignored) plus
        overrides."""
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in fields}
        kw.update(overrides)
        return cls(**kw)


def is_moonlight(config) -> bool:
    return isinstance(config, MoonlightConfig)
