"""Configuration system.

Parses the reference's whitespace ``conf`` format with identical
semantics (`Utils/Arguments.py:41-66`); copy of ``ruart_tpu/core/config.py``
without the file readers:

* lines starting with ``#`` are comments
* ``key`` alone -> boolean flag ``True`` ("key present" semantics)
* ``key value`` -> value auto-coerced to int, then float, then bool
* duplicate keys: first occurrence wins (a warning is emitted)
* tabs are treated as spaces; lines with >2 fields are ignored (reference
  behavior: only ``len(parts) in (1, 2)`` are handled)

On top of the raw option dict, :class:`Config` derives the full dimension
flow of the model (`Models/SDNet.py:48-244`) once, so model code never has
to re-derive sizes from flags.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Iterator, Optional

log = logging.getLogger(__name__)


def _coerce(value: str) -> Any:
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def read_conf_lines(lines) -> Dict[str, Any]:
    opt: Dict[str, Any] = {}
    for line in lines:
        stripped = line.replace("\t", " ").strip()
        if stripped.startswith("#"):
            continue
        parts = stripped.split()
        if len(parts) == 1:
            opt.setdefault(parts[0], True)
        elif len(parts) == 2:
            key, value = parts
            if key in opt:
                log.warning("conf key %s already exists; first value wins", key)
            else:
                opt[key] = _coerce(value)
    return opt


def read_conf_file(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"The argument file does not exist: {path}")
    with open(path, encoding="utf-8") as f:
        return read_conf_lines(f)


# the longest encoder row the Moonlight encoder takes: the attention
# kernel's limit (ops/attention.MAX_LEN)
LLM_MAX_ROW_LEN = 512
# conf keys whose values bound an encoder row's width
ROW_CAP_KEYS = ("max_q_bert_len", "max_ocr_bert_len", "max_od_bert_len",
                "bert_pack_len")


def llm_encoder_dims(opt: Dict[str, Any]) -> tuple:
    """(hidden_size, num_hidden_layers) of the ``LLM_ENCODER`` config.json."""
    import json

    with open(str(opt["LLM_ENCODER"])) as f:
        raw = json.load(f)
    return int(raw["hidden_size"]), int(raw["num_hidden_layers"])


def llm_encoder_conflicts(opt: Dict[str, Any]) -> list:
    """What the conf combines with ``LLM_ENCODER`` that the Moonlight
    encoder does not run: BERT_LARGE, INT8_BERT, or rows over
    :data:`LLM_MAX_ROW_LEN` tokens (the chunked encoder path)."""
    out = [k for k in ("BERT_LARGE", "INT8_BERT") if k in opt]
    out += [f"{k} {opt[k]} (rows over {LLM_MAX_ROW_LEN})" for k in ROW_CAP_KEYS
            if k in opt and int(opt[k]) > LLM_MAX_ROW_LEN]
    return out


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Derived dimension flow of the fusion network.

    Mirrors the size bookkeeping in the reference constructor
    (`Models/SDNet.py:48-244`) so checkpoints and parity tests agree on every
    intermediate width.
    """

    vocab_dim: int              # word-vector dim used by pre-align (300)
    ques_input_size: int        # question embedding concat width
    x_input_size: int           # ocr/od embedding concat width
    multi2one_output: int
    context_rnn_output: int     # per-layer output width of the context BiLSTM
    ques_rnn_output: int        # per-layer output width of the question BiLSTM
    in_rnn_layers: int
    word_hidden_size: int       # word-level width fed to deep attention
    deep_att_size: int          # attention input width inside DeepAttention
    deep_attn_input_size: int   # concat width fed to DeepAttention's RNN
    deep_attn_output_size: int
    high_lvl_ques_output: int
    self_attn_input_size: int
    self_attn_output_size: int
    context_final_size: int
    ques_final_size: int
    position_att_output_size: int
    ocr_final_size: int
    bert_dim: int
    bert_layers: int
    pos_vocab: int
    ent_vocab: int
    num_scores: int             # width of the final score vector


class Config:
    """Typed view over a reference-format option dict.

    Supports the reference's "flag present" membership test (``'GLOVE' in
    cfg``) and item access, while exposing derived dims via ``cfg.dims``.
    """

    # spaCy en_core_web_sm 2.x tag / NER-move-name spaces have fixed sizes; the
    # reference sizes its embeddings from them (`Utils/CoQAUtils.py:31-32`).
    # 50 tags + '' and 18 entity types x (B/I/L/U moves + O...) + '' -- we pin
    # the exact table in ruart_tpu_torch.text.featurizer and read sizes from there.
    def __init__(self, opt: Dict[str, Any]):
        from ruart_tpu_torch.text.featurizer import POS_VOCAB_SIZE, ENT_VOCAB_SIZE

        self.opt = dict(opt)
        self._pos_vocab = POS_VOCAB_SIZE
        self._ent_vocab = ENT_VOCAB_SIZE
        self._derive_dims()  # validate eagerly

    @property
    def dims(self) -> "ModelDims":
        # re-derived on access: the trainer fills in runtime keys
        # (vocab_size from meta, fixed_answers_len from the answers file)
        # after construction, like the reference mutating its opt dict
        return self._derive_dims()

    # --- dict-like API (reference `opt` compatibility) -------------------
    def __contains__(self, key: str) -> bool:
        return key in self.opt

    def __getitem__(self, key: str) -> Any:
        return self.opt[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.opt.get(key, default)

    def __iter__(self) -> Iterator[str]:
        return iter(self.opt)

    # --- convenience accessors -------------------------------------------
    @property
    def q_embedding(self):
        return self.opt["q_embedding"].split(",")

    @property
    def ocr_embedding(self):
        return self.opt["ocr_embedding"].split(",")

    @property
    def batch_size(self) -> int:
        return int(self.opt.get("batch_size", 16))

    @property
    def max_ocr_num(self) -> int:
        return int(self.opt["max_ocr_num"])

    @property
    def max_od_num(self) -> int:
        return int(self.opt["max_od_num"])

    @property
    def max_ocr_len(self) -> int:
        return int(self.opt["max_ocr_len"])

    @property
    def max_od_len(self) -> int:
        return int(self.opt["max_od_len"])

    @property
    def max_q_len(self) -> int:
        return int(self.opt["max_q_len"])

    @property
    def max_q_bert_len(self) -> int:
        return int(self.opt["max_q_bert_len"])

    @property
    def max_ocr_bert_len(self) -> int:
        return int(self.opt["max_ocr_bert_len"])

    @property
    def max_od_bert_len(self) -> int:
        return int(self.opt["max_od_bert_len"])

    @property
    def yesno_num(self) -> int:
        return 3 if "label_yesno" in self.opt else 0

    @property
    def fixed_answers_len(self) -> int:
        if "fixed_answers" in self.opt:
            # 0 until the trainer loads the answers file and fills it in
            return int(self.opt.get("fixed_answers_len", 0))
        return 0

    @property
    def es_ocr_len(self) -> Optional[int]:
        return int(self.opt["ES_ocr_len"]) if "ES_ocr" in self.opt else None

    @property
    def dropout_p(self) -> float:
        return float(self.opt.get("DROPOUT", 0.0)) if "DROPOUT" in self.opt else 0.0

    @property
    def seed(self) -> int:
        return int(self.opt.get("SEED", 0))

    # --- dimension derivation --------------------------------------------
    def _derive_dims(self) -> ModelDims:
        opt = self.opt
        q_emb = self.q_embedding
        ocr_emb = self.ocr_embedding

        glove_dim = int(opt.get("glove_dim", 300)) if "GLOVE" in opt else 0
        fast_dim = int(opt.get("fast_dim", 300)) if "FastText" in opt else 0
        phoc_dim = int(opt.get("phoc_dim", 604)) if "PHOC" in opt else 0

        if "BERT" in opt:
            if "LLM_ENCODER" in opt:
                bert_dim, bert_layers = llm_encoder_dims(opt)
            elif "BERT_LARGE" in opt:
                bert_dim, bert_layers = 1024, 24
            else:
                bert_dim, bert_layers = 768, 12
        else:
            bert_dim, bert_layers = 0, 0

        def emb_width(names) -> int:
            w = 0
            if "glove" in names:
                w += glove_dim
            if "fasttext" in names:
                w += fast_dim
            if "phoc" in names:
                w += phoc_dim
            if "bert" in names or "bert_only" in names:
                w += bert_dim
            if "pos" in names:
                w += int(opt["pos_dim"])
            if "ent" in names:
                w += int(opt["ent_dim"])
            return w

        ques_input_size = emb_width(q_emb)
        x_input_size = emb_width(ocr_emb)

        # Word-vector width used by pre-align and deep attention. The
        # reference hardcodes 300 (`SDNet.py:25`) == its glove/fasttext dim;
        # deriving it keeps scaled-down test configs consistent.
        if "GLOVE" in opt:
            vocab_dim = glove_dim
        elif "FastText" in opt:
            vocab_dim = fast_dim
        else:
            vocab_dim = 300
        if "PRE_ALIGN" in opt and "PRE_ALIGN_befor_rnn" in opt:
            x_input_size += vocab_dim

        hidden_size = int(opt["hidden_size"])
        in_rnn_layers = int(opt["in_rnn_layers"])
        highlvl_hidden_size = int(opt["highlvl_hidden_size"])
        concat_rnn = bool(opt.get("concat_rnn", False))

        def rnn_out(hidden: int, layers: int, concat: bool, bidir: bool = True) -> int:
            out = hidden * (2 if bidir else 1)
            return out * layers if concat else out

        multi2one_bidir = bool(opt.get("multi2one_bidir", False))
        multi2one_output = rnn_out(
            int(opt["multi2one_hidden_size"]), 1, concat_rnn, multi2one_bidir
        )
        context_rnn_output = hidden_size * 2  # per-layer width (return_list path)
        ques_rnn_output = hidden_size * 2

        if "GLOVE" not in opt and "FastText" not in opt:
            word_hidden_size = 0
        else:
            word_hidden_size = multi2one_output

        abstr_hidden_size = hidden_size * 2
        if "no_DeepAttention" in opt:
            deep_att_size = 0
            deep_attn_input_size = abstr_hidden_size * in_rnn_layers
        else:
            deep_att_size = abstr_hidden_size * in_rnn_layers + word_hidden_size
            deep_attn_input_size = (
                abstr_hidden_size * in_rnn_layers * 2 + highlvl_hidden_size * 2
            )
        deep_attn_output_size = highlvl_hidden_size * 2

        high_lvl_ques_output = rnn_out(
            highlvl_hidden_size, int(opt["question_high_lvl_rnn_layers"]), True
        )

        self_attn_input_size = (
            deep_attn_output_size + deep_attn_input_size + multi2one_output
        )
        if "no_Context_Self_Attention" in opt:
            self_attn_output_size = 0
        else:
            self_attn_output_size = deep_attn_output_size

        context_final_size = highlvl_hidden_size * 2
        ques_final_size = high_lvl_ques_output

        position_att_output_size = 0
        if "position_dim" in opt:
            if opt["position_mod"] == "qk+":
                position_att_output_size = context_final_size
            elif opt["position_mod"] == "cat":
                position_att_output_size = context_final_size + int(opt["position_dim"])

        merge = opt.get("pos_att_merge_mod", "original")
        if merge == "cat":
            ocr_final_size = context_final_size + position_att_output_size
        elif merge == "atted":
            ocr_final_size = position_att_output_size
        else:
            ocr_final_size = context_final_size

        num_scores = self.fixed_answers_len + self.yesno_num + self.max_ocr_num
        if "label_no_answer" in opt:
            num_scores += 1

        return ModelDims(
            vocab_dim=vocab_dim,
            ques_input_size=ques_input_size,
            x_input_size=x_input_size,
            multi2one_output=multi2one_output,
            context_rnn_output=context_rnn_output,
            ques_rnn_output=ques_rnn_output,
            in_rnn_layers=in_rnn_layers,
            word_hidden_size=word_hidden_size,
            deep_att_size=deep_att_size,
            deep_attn_input_size=deep_attn_input_size,
            deep_attn_output_size=deep_attn_output_size,
            high_lvl_ques_output=high_lvl_ques_output,
            self_attn_input_size=self_attn_input_size,
            self_attn_output_size=self_attn_output_size,
            context_final_size=context_final_size,
            ques_final_size=ques_final_size,
            position_att_output_size=position_att_output_size,
            ocr_final_size=ocr_final_size,
            bert_dim=bert_dim,
            bert_layers=bert_layers,
            pos_vocab=self._pos_vocab,
            ent_vocab=self._ent_vocab,
            num_scores=num_scores,
        )

    @classmethod
    def from_file(cls, path: str, **overrides: Any) -> "Config":
        opt = read_conf_file(path)
        opt.update(overrides)
        opt.setdefault("confFile", path)
        opt.setdefault("datadir", os.path.dirname(path))
        return cls(opt)
