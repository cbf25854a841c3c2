"""Static model specification.

A frozen snapshot of every conf-derived flag/size the fusion network
needs. Built once from a :class:`ruart_tpu_torch.core.config.Config`; the
raw opt dict never reaches the model. Copy of
``ruart_tpu/models/fusion/spec.py``. ``BF16`` runs the encoder in bf16
(``BertConfig.dtype``; the fusion stack stays fp32); ``INT8_BERT`` selects
the weight-only int8 encoder (``BertConfig.quant``); ``LLM_ENCODER <path
to config.json>`` the Moonlight encoder (``MoonlightConfig``) in BERT's
slot, refused beside BERT_LARGE, INT8_BERT and rows over 512."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ruart_tpu_torch.core.config import Config, llm_encoder_conflicts
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.moonlight.config import MoonlightConfig


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    # embedding sources
    q_embedding: Tuple[str, ...]
    ocr_embedding: Tuple[str, ...]
    q_emb_initial: str
    ocr_emb_initial: str
    use_glove: bool
    use_fasttext: bool
    use_phoc: bool
    use_bert: bool
    bert_linear_combine: bool
    lock_bert: bool
    # fuse the q / OCR / OD encoder invocations into one batched Bert call
    # whenever their token widths match (exact math — see
    # RUArtModel._fused_bert; `bert_fuse 0` opts out)
    bert_fuse: bool
    vocab_size: int
    glove_dim: int
    fast_dim: int
    phoc_dim: int
    pos_vocab: int
    ent_vocab: int
    pos_dim: int
    ent_dim: int
    # architecture sizes
    vocab_dim: int
    prealign_hidden: int
    hidden_size: int
    in_rnn_layers: int
    highlvl_hidden_size: int
    question_high_lvl_rnn_layers: int
    deep_att_hidden_size_per_abstr: int
    query_self_attn_hidden_size: int
    multi2one_hidden_size: int
    multi2one_bidir: bool
    concat_rnn: bool
    # flags
    pre_align: bool
    pre_align_before_rnn: bool
    pre_align_after_rnn: bool
    no_context_self_attention: bool
    no_deep_attention: bool
    position_dim: int
    position_mod: str          # 'qk+' | 'cat' | '' (disabled)
    pos_att_merge_mod: str     # 'cat' | 'atted' | 'original'
    label_yesno: bool
    label_no_answer: bool
    use_es: bool
    es_ocr_len: int
    es_using_way: str          # 'as_ocr' | 'post_process'
    mask_score: bool
    fixed_answers: bool
    fixed_answers_len: int
    img_feature: bool
    img_fea_way: str           # 'replace_od' | 'final_att' | ''
    img_fea_num: int
    img_fea_dim: int
    # dropout
    dropout_p: float
    dropout_emb: float
    variational: bool
    # bert
    bert: Optional[BertConfig]  # or a MoonlightConfig (LLM_ENCODER)

    @classmethod
    def from_config(cls, cfg: Config, bert_config: Optional[BertConfig] = None):
        opt = cfg.opt
        use_bert = "BERT" in opt
        if use_bert and "LLM_ENCODER" in opt:
            conflicts = llm_encoder_conflicts(opt)
            if conflicts:
                raise ValueError("LLM_ENCODER (the Moonlight encoder) cannot "
                                 "be combined with " + ", ".join(conflicts))
            if not isinstance(bert_config, MoonlightConfig):
                bert_config = MoonlightConfig.from_json(str(opt["LLM_ENCODER"]))
        if use_bert and bert_config is None:
            bert_config = (
                BertConfig.large_uncased() if "BERT_LARGE" in opt else BertConfig()
            )
        # BF16 conf flag: the encoder computes in bf16, the fusion stack
        # stays fp32 (no reference equivalent: the reference is fp32 only)
        if use_bert and "BF16" in opt and bert_config.dtype != "bfloat16":
            bert_config = dataclasses.replace(bert_config, dtype="bfloat16")
        # INT8_BERT conf flag: weight-only int8 encoder (frozen-BERT serving
        # mode, no reference equivalent — ops/quant.py). Weights must go
        # through quantize_bert_params after load.
        if use_bert and "INT8_BERT" in opt and bert_config.quant != "int8":
            bert_config = dataclasses.replace(bert_config, quant="int8")
        return cls(
            q_embedding=tuple(cfg.q_embedding),
            ocr_embedding=tuple(cfg.ocr_embedding),
            q_emb_initial=opt.get("q_emb_initial", "glove"),
            ocr_emb_initial=opt.get("ocr_emb_initial", "fasttext"),
            use_glove="GLOVE" in opt,
            use_fasttext="FastText" in opt,
            use_phoc="PHOC" in opt,
            use_bert=use_bert,
            bert_linear_combine="BERT_LINEAR_COMBINE" in opt,
            lock_bert="LOCK_BERT" in opt,
            bert_fuse=bool(int(opt.get("bert_fuse", 1))),
            vocab_size=int(opt.get("vocab_size", 0)),
            glove_dim=int(opt.get("glove_dim", 300)),
            fast_dim=int(opt.get("fast_dim", 300)),
            phoc_dim=int(opt.get("phoc_dim", 604)),
            pos_vocab=cfg.dims.pos_vocab,
            ent_vocab=cfg.dims.ent_vocab,
            pos_dim=int(opt.get("pos_dim", 12)),
            ent_dim=int(opt.get("ent_dim", 8)),
            vocab_dim=cfg.dims.vocab_dim,
            prealign_hidden=int(opt.get("prealign_hidden", 300)),
            hidden_size=int(opt["hidden_size"]),
            in_rnn_layers=int(opt["in_rnn_layers"]),
            highlvl_hidden_size=int(opt["highlvl_hidden_size"]),
            question_high_lvl_rnn_layers=int(opt["question_high_lvl_rnn_layers"]),
            deep_att_hidden_size_per_abstr=int(opt["deep_att_hidden_size_per_abstr"]),
            query_self_attn_hidden_size=int(opt["query_self_attn_hidden_size"]),
            multi2one_hidden_size=int(opt["multi2one_hidden_size"]),
            multi2one_bidir=bool(opt.get("multi2one_bidir", False)),
            concat_rnn=bool(opt.get("concat_rnn", False)),
            pre_align="PRE_ALIGN" in opt,
            pre_align_before_rnn="PRE_ALIGN_befor_rnn" in opt,
            pre_align_after_rnn="PRE_ALIGN_after_rnn" in opt,
            no_context_self_attention="no_Context_Self_Attention" in opt,
            no_deep_attention="no_DeepAttention" in opt,
            position_dim=int(opt.get("position_dim", 0)) if "position_dim" in opt else 0,
            position_mod=opt.get("position_mod", "") if "position_dim" in opt else "",
            pos_att_merge_mod=opt.get("pos_att_merge_mod", "original"),
            label_yesno="label_yesno" in opt,
            label_no_answer="label_no_answer" in opt,
            use_es="useES" in opt,
            es_ocr_len=int(opt.get("ES_ocr_len", 0)),
            es_using_way=opt.get("ES_using_way", "as_ocr"),
            mask_score="mask_score" in opt,
            fixed_answers="fixed_answers" in opt,
            fixed_answers_len=int(opt.get("fixed_answers_len", 0)),
            img_feature="img_feature" in opt,
            img_fea_way=opt.get("img_fea_way", ""),
            img_fea_num=int(opt.get("img_fea_num", 36)),
            img_fea_dim=int(opt.get("img_fea_dim", 2048)),
            dropout_p=cfg.dropout_p,
            dropout_emb=float(opt.get("dropout_emb", 0.0)),
            variational="VARIATIONAL_DROPOUT" in opt,
            bert=bert_config,
        )

    @property
    def multi2one_output(self) -> int:
        out = self.multi2one_hidden_size * (2 if self.multi2one_bidir else 1)
        return out  # single layer; concat_rnn over 1 layer is identity

    @property
    def context_final_size(self) -> int:
        return self.highlvl_hidden_size * 2

    @property
    def ques_final_size(self) -> int:
        base = self.highlvl_hidden_size * 2 * self.question_high_lvl_rnn_layers
        return base

    @property
    def position_att_output_size(self) -> int:
        if not self.position_mod:
            return 0
        if self.position_mod == "qk+":
            return self.context_final_size
        return self.context_final_size + self.position_dim

    @property
    def ocr_final_size(self) -> int:
        if self.pos_att_merge_mod == "cat":
            return self.context_final_size + self.position_att_output_size
        if self.pos_att_merge_mod == "atted":
            return self.position_att_output_size
        return self.context_final_size
