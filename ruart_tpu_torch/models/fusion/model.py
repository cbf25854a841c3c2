"""RUArt fusion network in PyTorch — port of
``ruart_tpu/models/fusion/model.py``.

The same forward as the JAX package (`Models/SDNet.py:253-437`
semantics), with every conf branch of it: candidates live in fixed-shape
[B, N, L] tensors, the three BERT calls (question / OCR / OD) share one
encoder and fuse into one batched call where their token widths match,
the 12-layer α-combine happens before subword pooling, and the
per-candidate stage runs on compacted rows when the collator attached
``cand_sel``. Batch schema: see the JAX module's docstring. Modules and
parameters exist only where the JAX ``setup`` creates them, so the weight
bridge maps every leaf.

Training mode (``model.train()``) runs dropout at every site the JAX
forward has (``DROPOUT`` in the fusion layers and LSTM stacks,
``dropout_emb`` on the word and BERT embeddings), with masks drawn from the
generator :meth:`RUArtModel.seed_dropout` installs; under ``LOCK_BERT`` the
encoder runs without a graph while the α-combine weights still train.

With a (dp, tp) rank mesh (``RUArtModel(spec, mesh)``) the model computes
this rank's share of the JAX program on the global batch: the per-sample
grids hold the rank's dp slice of the rows, the batch-global encoder tables
(``GLOBAL_KEYS``) come whole. Each encoder call over batch-global rows
encodes this rank's contiguous share of them and sums the zero-padded
shares over dp (``parallel.layers.gather_rows``), so dp divides the
encoder's work and every rank gets the whole table; ``cand_sel`` is mapped
onto the rank's candidate rows (the others become pad rows); the
whole-tensor layer norm sums its moments over dp; each dropout site draws
the global batch's mask and keeps the rank's rows. Under tp the encoder is
tensor-parallel (``models/bert/model.py``) and the glove/fast tables are
split by rows, as ``parallel.mesh._PARAM_RULES`` lays them out.

Every conf branch of the JAX model is ported (:func:`unported_conf_keys`
is empty); ``PHOC`` reads a frozen [vocab, 604] table
(``install_embeddings``), split by rows over tp like the glove/fast ones.
Three confs that the JAX forward cannot run either are refused at
construction with a ValueError (:func:`_check_runnable`).

``models/fusion/introspect.py`` collects what the JAX forward ``sow``s:
each ``Attention``'s alpha and the candidate embedding before multi2one
(``RUArtModel.sown_cand_emb``), only while it records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ruart_tpu_torch.models.bert.model import BertModel, subword_to_word_pooling
from ruart_tpu_torch.models.fusion.deep_attention import DeepAttention
from ruart_tpu_torch.models.fusion.layers import (
    Attention,
    Dropper,
    GetFinalScores,
    LinearSelfAttn,
    weighted_avg,
)
from ruart_tpu_torch.models.fusion.rnn import StackedBRNN, gather_last_state
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.parallel.layers import gather_rows, row_range, vocab_embedding
from ruart_tpu_torch.parallel.mesh import param_dim

POSITION_WIDTH = 8  # normalized box quad per candidate

# batch-global tables and indices of a candidate block; every other key is
# a per-candidate [B, N, ...] grid
GLOBAL_KEYS = (
    "bert_unique", "bert_packed", "bert_packed_seg", "bert_packed_pos",
    "bert_unpack", "bert_unique_offsets", "cand_sel",
)


def unported_conf_keys(s: ModelSpec) -> List[str]:
    """The conf branches of ``spec`` this port does not implement: none."""
    return []


def _check_runnable(s: ModelSpec) -> None:
    """Refuse the confs whose JAX forward fails: without GLOVE and FastText
    there is no word vector for pre-align and deep attention (KeyError
    'word_emb' there); ``pos_att_merge_mod`` other than original needs the
    OD->OCR attention of a ``position_mod`` (UnboundLocalError there);
    ``PRE_ALIGN_after_rnn`` needs ``PRE_ALIGN`` (UnboundLocalError)."""
    if not (s.use_glove or s.use_fasttext):
        raise ValueError("GLOVE and FastText both unset: pre-align and deep "
                         "attention need a word-vector embedding")
    if s.position_mod not in ("qk+", "cat") and s.pos_att_merge_mod != "original":
        raise ValueError(f"pos_att_merge_mod {s.pos_att_merge_mod} needs "
                         f"position_mod qk+ or cat, got "
                         f"{s.position_mod or '(unset)'}")
    if s.pre_align_after_rnn and not s.pre_align:
        raise ValueError("PRE_ALIGN_after_rnn needs PRE_ALIGN")


def _widen_ints(item: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Widen every integer grid (the collator ships int8/int16 grids under
    `h2d_narrow`) to int64, the index type of torch's gathers. Values are
    exact."""
    return {
        k: (v if v.is_floating_point() else v.long()) for k, v in item.items()
    }


def _flatten_cand(x: torch.Tensor) -> torch.Tensor:
    """[B, N, ...] -> [B*N, ...]"""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class RUArtModel(nn.Module):
    def __init__(self, spec: ModelSpec, mesh=None):
        """``mesh``: this rank's ``parallel.mesh.Mesh`` (see the module
        doc), or None on one rank."""
        super().__init__()
        _check_runnable(spec)
        s = self.spec = spec
        self.mesh = mesh
        # a list while introspect.record_intermediates records
        self.sown_cand_emb: Optional[List[torch.Tensor]] = None
        tp = mesh.tp if mesh is not None else 1

        def table(name, width):
            dim = param_dim(f"{name}.weight", (s.vocab_size, width), tp)
            return vocab_embedding(s.vocab_size, width, dim, mesh)

        if s.use_glove:
            self.glove_embed = table("glove_embed", s.glove_dim)
        if s.use_fasttext:
            self.fast_embed = table("fast_embed", s.fast_dim)
        if s.use_phoc:
            self.phoc_embed = table("phoc_embed", s.phoc_dim)
        names = s.q_embedding + s.ocr_embedding
        if "pos" in names:
            self.pos_embedding = nn.Embedding(s.pos_vocab, s.pos_dim)
        if "ent" in names:
            self.ent_embedding = nn.Embedding(s.ent_vocab, s.ent_dim)
        if s.use_bert:
            bert = s.bert if mesh is None else dataclasses.replace(
                s.bert, mesh=mesh)
            self.Bert = BertModel(bert)
            if s.bert_linear_combine:
                self.alphaBERT = nn.Parameter(
                    torch.ones(s.bert.num_hidden_layers))
                self.gammaBERT = nn.Parameter(torch.ones(1, 1))
        drop = dict(dropout_p=s.dropout_p, variational=s.variational)
        self.emb_drop = Dropper(s.dropout_emb, s.variational)

        q_word = self._word_dim(s.q_embedding)
        tok_word = self._word_dim(s.ocr_embedding)
        m2o = s.multi2one_output
        if not q_word == tok_word == m2o:
            raise ValueError(
                f"word-vector widths differ (question {q_word}, candidate "
                f"{tok_word}, multi2one {m2o}); pre-align and deep attention "
                "share one projection across both sides"
            )
        if s.pre_align:
            self.pre_align = Attention(
                tok_word, s.prealign_hidden, correlation_func=3,
                do_similarity=True, **drop,
            )
        m2o_in = self._emb_width(s.ocr_embedding) + (
            q_word if s.pre_align and s.pre_align_before_rnn else 0
        )
        self.multi2one = StackedBRNN(
            m2o_in, s.multi2one_hidden_size, 1,
            bidirectional=s.multi2one_bidir, **drop,
        )
        H, layers = s.hidden_size, s.in_rnn_layers
        self.context_rnn = StackedBRNN(m2o, H, layers, **drop)
        self.ques_rnn = StackedBRNN(
            self._emb_width(s.q_embedding), H, layers, **drop
        )
        abstr = 2 * H * layers
        # init_weights draws in registration order: a new module goes after
        # the existing ones of its conf, or a seed gives other weights
        self.high_lvl_ques_rnn = StackedBRNN(
            abstr, s.highlvl_hidden_size, s.question_high_lvl_rnn_layers,
            concat_layers=True, **drop,
        )
        values = [2 * H] * layers + [s.ques_final_size]
        self.deep_attn = DeepAttention(
            m2o + abstr, values, abstr, s.deep_att_hidden_size_per_abstr,
            s.highlvl_hidden_size, no_deep_attention=s.no_deep_attention,
            **drop,
        )
        inter = abstr + (0 if s.no_deep_attention else sum(values))
        ctx = 2 * s.highlvl_hidden_size
        if not s.no_context_self_attention:
            self.highlvl_self_att = Attention(
                ctx + inter + m2o, s.deep_att_hidden_size_per_abstr,
                correlation_func=3, **drop,
            )
        self.high_lvl_context_rnn = StackedBRNN(
            ctx if s.no_context_self_attention else 2 * ctx,
            s.highlvl_hidden_size, 1, **drop,
        )
        self.ques_self_attn = Attention(
            s.ques_final_size, s.query_self_attn_hidden_size,
            correlation_func=3, **drop,
        )
        if s.position_mod == "qk+":
            self.od_ocr_attn = Attention(
                ctx, H, correlation_func=3, do_similarity=True, **drop
            )
            self.position_attn = Attention(
                POSITION_WIDTH, H, correlation_func=3, do_similarity=True,
                **drop,
            )
        elif s.position_mod == "cat":
            self.od_ocr_attn = Attention(
                ctx + POSITION_WIDTH, H, correlation_func=3,
                do_similarity=True, **drop,
            )
        self.ques_merger = LinearSelfAttn(s.ques_final_size, **drop)
        if s.img_feature and s.img_fea_way == "replace_od":
            self.img_fea2od = nn.Linear(s.img_fea_dim, m2o)
        self.get_answer = GetFinalScores(
            s.ocr_final_size, s.ques_final_size, yesno=s.label_yesno,
            no_answer=s.label_no_answer, use_es=s.use_es, **drop,
        )
        if s.fixed_answers:
            self.fixed_ans_classifier = nn.Linear(
                s.ques_final_size, s.fixed_answers_len + 1
            )
            self.fixed_ocr_alpha = nn.Parameter(torch.full((1, 1), 0.5))
        if s.use_es and s.es_using_way == "post_process":
            self.ES_linear = nn.Linear(m2o, s.ocr_final_size)
            self.ES_ocr_att = Attention(
                s.ocr_final_size, H, correlation_func=3, do_similarity=True,
                **drop,
            )
        # the dropout sites' row layouts of the forward in flight (filled
        # per forward on a dp mesh), and the layer norms' dp group
        self._rows: Dict[str, Tuple[int, int]] = {}
        for mod in self.modules():
            if isinstance(mod, Dropper):
                mod.rows = self._rows
            elif isinstance(mod, StackedBRNN):
                mod.ln_group = mesh.dp_group if mesh is not None else None

    def _dp(self) -> Tuple[int, int]:
        """(dp size, this rank's dp index)."""
        if self.mesh is None:
            return 1, 0
        return self.mesh.dp, self.mesh.dp_rank

    # -- widths ------------------------------------------------------------
    def _word_dim(self, names) -> int:
        """Width of the raw word vector (fasttext-if-present priority)."""
        s = self.spec
        return s.fast_dim if "fasttext" in names else s.glove_dim

    def _emb_width(self, names) -> int:
        s = self.spec
        bert = s.bert.hidden_size if s.use_bert else 0
        widths = (
            ("phoc", s.phoc_dim), ("fasttext", s.fast_dim),
            ("glove", s.glove_dim), ("bert", bert), ("bert_only", bert),
            ("pos", s.pos_dim), ("ent", s.ent_dim),
        )
        return sum(w for name, w in widths if name in names)

    # -- random init -------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RUArtModel":
        """Random weights drawn from ``generator`` (on the parameters'
        device): BERT weights N(0, initializer_range); word vectors
        U(-1, 1); other linears U(±1/sqrt(fan_in)); LSTMs U(±1/sqrt(H));
        biases 0; LayerNorm 1/0; α, γ and diagonals 1."""
        std = self.spec.bert.initializer_range if self.spec.use_bert else 0.0
        for name, mod in self.named_modules():
            in_bert = name == "Bert" or name.startswith("Bert.")
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                if in_bert:
                    mod.weight.normal_(0.0, std, generator=generator)
                else:
                    mod.weight.uniform_(-1.0, 1.0, generator=generator)
            elif isinstance(mod, nn.Linear):
                if in_bert:
                    mod.weight.normal_(0.0, std, generator=generator)
                else:
                    bound = 1.0 / math.sqrt(mod.in_features)
                    mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LSTM):
                bound = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    p.uniform_(-bound, bound, generator=generator)
        for name, p in self.named_parameters():
            if name.split(".")[-1] in ("alphaBERT", "gammaBERT", "diagonal"):
                p.fill_(1.0)
        return self

    def seed_dropout(self, seed: int) -> torch.Generator:
        """Give every dropout site one ``torch.Generator`` on the
        parameters' device, seeded with ``seed``. Returns it."""
        device = self.alphaBERT.device
        generator = torch.Generator(device=device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, Dropper):
                mod.generator = generator
        return generator

    # -- encoder -----------------------------------------------------------
    @staticmethod
    def _word_mask(item, initial: str) -> torch.Tensor:
        """Word mask keyed by the *_emb_initial conf value
        (`SDNet.py:470-480`)."""
        key = "fasttext" if initial == "fasttext" else "glove"
        return (item[key] != 0).float()

    @staticmethod
    def _mask_by_membership(item, names) -> torch.Tensor:
        """Word mask with fasttext-if-present priority
        (`SDNet.py:269-274,507-518`)."""
        key = "fasttext" if "fasttext" in names else "glove"
        return (item[key] != 0).float()

    def _combine_weights(self) -> torch.Tensor:
        return torch.softmax(self.alphaBERT, dim=0) * self.gammaBERT.reshape(())

    def _encode(self, ids, mask=None, global_rows: bool = False,
                **kw) -> torch.Tensor:
        """One encoder call -> [R, L, D] fp32: the α-combined layers under
        BERT_LINEAR_COMBINE, else the last layer. LOCK_BERT runs the
        encoder without a graph either way. ``global_rows``: the rows are a
        batch-global table, the same on every rank; on a dp mesh each rank
        encodes its share and the shares are summed over dp."""
        dp, d = self._dp()
        if global_rows and dp > 1:
            n = ids.shape[0]
            a, b = row_range(n, dp, d)
            part = self._encode(
                ids[a:b], None if mask is None else mask[a:b],
                **{k: v[a:b] for k, v in kw.items()})
            return gather_rows(part, a, n, self.mesh.dp_group)
        s = self.spec
        if s.bert_linear_combine:
            return self.Bert(ids, mask, combine_weights=self._combine_weights(),
                             stop_layer_gradients=s.lock_bert, **kw)[0]
        return self.Bert(ids, mask, stop_layer_gradients=s.lock_bert,
                         **kw)[0][-1]

    def _bert_row_spec(self, item) -> Optional[Tuple[torch.Tensor, ...]]:
        """(ids, seg, pos) encoder rows of one q/candidate block in segment
        form, or None when the block needs the in-place path (> 512
        chunking). Candidate blocks come flattened to [B*N, Lb]. The rows
        are batch-global exactly when they come from a packed or unique
        table (:func:`_global_rows`)."""
        if "bert_packed" in item:
            ids = item["bert_packed"]
            seg, pos = item["bert_packed_seg"], item["bert_packed_pos"]
        else:
            ids = item["bert_unique"] if "bert_unique" in item else item["bert"]
            seg = (ids != 0).long()
            pos = torch.arange(ids.shape[-1], device=ids.device)[None].expand(
                ids.shape
            )
        if ids.shape[-1] > self.spec.bert.max_position_embeddings:
            return None
        return ids, seg, pos

    @staticmethod
    def _global_rows(item) -> bool:
        return "bert_packed" in item or "bert_unique" in item

    def _fused_bert(self, q, ocr, od, od_encodes: bool
                    ) -> Dict[str, torch.Tensor]:
        """ONE encoder call over every block whose rows share a token width
        (`bert_fuse`, default on). q rows join as single-segment rows, so
        fusion is exact. Blocks whose width matches no other block keep
        their own call in :meth:`_bert_words`; the OD block joins only when
        it is encoded (``od_encodes``: not under ``img_feature``
        replace_od/final_att). Returns {block key: encoded rows [R, L, D]}
        for the fused blocks."""
        s = self.spec

        def has_bert(names):
            return "bert" in names or "bert_only" in names

        def has_ids(item):
            # h2d_slim drops the dense `bert` grid when a table rides along
            return ("bert" in item or "bert_packed" in item
                    or "bert_unique" in item)

        specs = []
        shared = {}  # block key -> its rows are batch-global
        if has_bert(s.q_embedding) and has_ids(q):
            sp = self._bert_row_spec(q)
            if sp is not None:
                specs.append(("q", sp))
                shared["q"] = self._global_rows(q)
        for key, item, on in (("ocr", ocr, True), ("od", od, od_encodes)):
            if not (on and has_bert(s.ocr_embedding) and has_ids(item)):
                continue
            flat = item
            if "bert_packed" not in item and "bert_unique" not in item:
                if "cand_sel" in item:
                    # dense rows are compact-gathered inside
                    # _encode_candidates
                    continue
                flat = {"bert": _flatten_cand(item["bert"])}
            sp = self._bert_row_spec(flat)
            if sp is not None:
                specs.append((key, sp))
                shared[key] = self._global_rows(flat)
        by_width: Dict[int, list] = {}
        for key, sp in specs:
            by_width.setdefault(sp[0].shape[-1], []).append((key, sp))
        out: Dict[str, torch.Tensor] = {}
        for grp in by_width.values():
            if len(grp) < 2:
                continue
            ids, seg, pos = (
                torch.cat([sp[i] for _, sp in grp], dim=0) for i in range(3)
            )
            encoded = self._encode(
                ids, global_rows=all(shared[key] for key, _ in grp),
                segment_ids=seg, position_ids=pos)
            ofs = 0
            for key, sp in grp:
                n = sp[0].shape[0]
                out[key] = encoded[ofs:ofs + n]
                ofs += n
        return out

    def _bert_words(self, item, word_mask, encoded=None,
                    layout: str = "dense") -> torch.Tensor:
        """BERT encode + α-combine (or the last layer) + word pooling.
        ``encoded`` holds rows already encoded by :meth:`_fused_bert`.
        Sequences longer than ``max_position_embeddings`` are encoded in
        chunks concatenated on the sequence axis, positions restarting per
        chunk (`Bert.py:94-101`). ``dropout_emb`` applies under
        BERT_LINEAR_COMBINE only, as in the JAX package."""
        packed = "bert_packed" in item
        dedup = "bert_unique" in item
        if encoded is not None:
            combined = encoded
        else:
            kw = {}
            mask = None
            if packed:
                ids = item["bert_packed"]
                kw = dict(segment_ids=item["bert_packed_seg"],
                          position_ids=item["bert_packed_pos"])
            elif dedup:
                ids = item["bert_unique"]
                mask = (ids != 0).long()
            else:
                ids, mask = item["bert"], item["bert_mask"]
            max_len = self.spec.bert.max_position_embeddings
            width = ids.shape[-1]
            if packed and width > max_len:
                raise ValueError("packed rows exceed max_position_embeddings")
            chunks = [
                self._encode(ids[:, a:a + max_len],
                             None if mask is None else mask[:, a:a + max_len],
                             global_rows=packed or dedup, **kw)
                for a in range(0, width, max_len)
            ]
            combined = chunks[0] if len(chunks) == 1 else torch.cat(chunks, 1)
        if self.spec.bert_linear_combine:
            def drop(x):
                return self.emb_drop(x, layout)
        else:
            def drop(x):
                return x
        if packed:
            R, Lp, D = combined.shape
            flat_tokens = combined.reshape(R * Lp, D)
        if (packed or dedup) and "bert_unique_offsets" in item:
            # pool-before-expand: pool on the unique table, then expand the
            # pooled words to candidates (the word mask is applied after)
            if packed:
                unpack = item["bert_unpack"]
                combined = flat_tokens.index_select(
                    0, unpack.reshape(-1)
                ).reshape(*unpack.shape, D)
            uo = item["bert_unique_offsets"]
            ones = torch.ones(uo.shape[:2], device=uo.device)
            pooled_u = subword_to_word_pooling(combined, uo, ones)
            pooled = pooled_u.index_select(0, item["bert_inverse"])
            return drop(pooled * word_mask[..., None])
        if packed:
            # compose the unpack with the duplicate expansion in one gather
            idx = item["bert_unpack"].index_select(0, item["bert_inverse"])
            combined = flat_tokens.index_select(0, idx.reshape(-1)).reshape(
                *idx.shape, D
            )
        elif dedup:
            combined = combined.index_select(0, item["bert_inverse"])
        return drop(subword_to_word_pooling(
            combined, item["bert_offsets"], word_mask
        ))

    def _embed(self, item, names, initial, encoded_bert=None,
               layout: str = "dense"):
        """Concatenated embedding (`SDNet.py:439-493`). Returns
        (embedding, raw word vectors for pre-align / deep attention); the
        word and BERT parts of the embedding take ``dropout_emb``, the raw
        word vectors do not. ``layout``: the row layout of ``item``'s
        grids ('dense' for the question block, 'flat' for candidate
        rows)."""
        embs = []
        word_emb = None
        if "phoc" in names:
            embs.append(self.emb_drop(self.phoc_embed(item["phoc"]), layout))
        if "fasttext" in names:
            word_emb = self.fast_embed(item["fasttext"])
            embs.append(self.emb_drop(word_emb, layout))
        if "glove" in names:
            glove = self.glove_embed(item["glove"])
            if word_emb is None:
                word_emb = glove
            embs.append(self.emb_drop(glove, layout))
        if "bert" in names or "bert_only" in names:
            embs.append(self._bert_words(
                item, self._word_mask(item, initial), encoded_bert, layout
            ))
        if "pos" in names:
            embs.append(self.pos_embedding(item["pos"]))
        if "ent" in names:
            embs.append(self.ent_embedding(item["ent"]))
        return torch.cat(embs, dim=-1), word_emb

    def _encode_candidates(self, item, q_word_emb, q_word_mask,
                           encoded_bert=None):
        """Token embed + pre-align + multi2one -> candidate vectors.
        Returns (cand [B, N, multi2one_out], cand_mask [B, N])."""
        s = self.spec
        B, N, L = item["fasttext" if s.use_fasttext else "glove"].shape[:3]
        flat = {
            k: (v if k in GLOBAL_KEYS else _flatten_cand(v))
            for k, v in item.items() if k != "num"
        }
        sel = flat.pop("cand_sel", None)
        row_index = None
        dp, d = self._dp()
        if sel is not None and dp > 1:
            # cand_sel indexes the global batch's B*N*dp candidate rows:
            # keep this rank's, the others become pad rows (the sentinel)
            local = sel - d * B * N
            sel = torch.where((local >= 0) & (local < B * N), local,
                              torch.full_like(local, B * N))
        if dp > 1:
            # compacted rows have the global row count on every rank;
            # the dense [B*N] rows are this rank's slice of B*N*dp
            self._rows.pop("flat", None)
            if sel is None:
                self._rows["flat"] = (B * N * dp, d * B * N)
        if sel is not None:
            # candidate-row compaction: the per-candidate stage runs on the
            # gathered real rows; pad entries carry the sentinel B*N, which
            # is clamped in-bounds for every gather and contributes zeros
            # to the scatter-add
            valid = sel < B * N
            sel = sel.clamp(max=B * N - 1)
            flat = {
                k: (v if k in GLOBAL_KEYS else v.index_select(0, sel))
                for k, v in flat.items()
            }
            row_index = torch.div(sel, N, rounding_mode="floor")
        emb, word_emb = self._embed(
            flat, s.ocr_embedding, s.ocr_emb_initial, encoded_bert, "flat"
        )
        if s.pre_align and s.pre_align_before_rnn:
            tok_mask = self._mask_by_membership(flat, s.ocr_embedding)
            if sel is not None:
                # each gathered row attends to its own question's words
                attended = self.pre_align(
                    word_emb, q_word_emb, q_word_mask, x2_row_index=row_index
                )
            else:
                attended = self.pre_align(
                    word_emb.reshape(B, N * L, -1), q_word_emb, q_word_mask
                ).reshape(B * N, L, -1)
            emb = torch.cat([emb, attended * tok_mask[..., None]], dim=-1)
        if self.sown_cand_emb is not None:
            self.sown_cand_emb.append(emb)
        last = gather_last_state(self.multi2one(emb, layout="flat"),
                                 flat["len"])
        if sel is not None:
            last = last * valid[:, None].float()
            cand = torch.zeros(
                B * N, last.shape[-1], dtype=last.dtype, device=last.device
            ).index_add_(0, sel, last)
        else:
            cand = last
        cand = cand.reshape(B, N, -1)
        cand_mask = (
            torch.arange(N, device=cand.device)[None, :] < item["num"][:, None]
        ).float()
        return cand * cand_mask[..., None], cand_mask

    # -- forward -------------------------------------------------------------
    def forward(self, q: Dict[str, torch.Tensor], ocr: Dict[str, torch.Tensor],
                od: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Softmaxed scores [B, n_scores] of one collated batch."""
        s = self.spec
        q, ocr, od = (_widen_ints(t) for t in (q, ocr, od))
        dp, d = self._dp()
        if dp > 1:
            B = ocr["num"].shape[0]
            self._rows["dense"] = (B * dp, d * B)
        img_od = s.img_feature and s.img_fea_way in ("replace_od", "final_att")
        fused = (self._fused_bert(q, ocr, od, not img_od)
                 if s.use_bert and s.bert_fuse else {})

        q_input, q_word_emb = self._embed(
            q, s.q_embedding, s.q_emb_initial, fused.get("q")
        )
        q_mask = self._word_mask(q, s.q_emb_initial)
        ocr_input, ocr_mask = self._encode_candidates(
            ocr, q_word_emb, q_mask, fused.get("ocr")
        )
        ocr_position = ocr["position"]
        if s.img_feature and s.img_fea_way == "replace_od":
            od_input = self.img_fea2od(q["img_features"])
            od_mask = torch.ones(od_input.shape[:2], device=od_input.device)
            od_position = q["img_spatials"]
        elif s.img_feature and s.img_fea_way == "final_att":
            # the reference zeroes the OD stream in this mode
            # (`SDNet.py:282-286`)
            B, M = od["position"].shape[:2]
            dev = od["position"].device
            od_input = torch.zeros(B, M, s.multi2one_output, device=dev)
            od_mask = torch.zeros(B, M, device=dev)
            od_position = od["position"]
        else:
            od_input, od_mask = self._encode_candidates(
                od, q_word_emb, q_mask, fused.get("od")
            )
            od_position = od["position"]

        # ES post_process split (`SDNet.py:292-324`): the first es_len
        # candidates leave the OCR stream; the rest shift down, and a
        # count under es_len keeps its original mask bits, as in the
        # reference
        es_post = s.use_es and s.es_using_way == "post_process"
        if es_post:
            es_len = s.es_ocr_len
            es_emb = ocr_input[:, :es_len]
            ocr_input = ocr_input[:, es_len:]
            ocr_position = ocr_position[:, es_len:]
            n_rest = ocr_input.shape[1]
            rest_cnt = (ocr["num"] - es_len).clamp(0, n_rest)
            rest = (torch.arange(n_rest, device=ocr_input.device)[None, :]
                    < rest_cnt[:, None]).float()
            keep_all = (ocr["num"] < es_len)[:, None]
            ocr_mask = torch.where(keep_all, ocr_mask[:, :n_rest], rest)
            es_mask = torch.ones(ocr_input.shape[0], es_len,
                                 device=ocr_input.device)

        if s.pre_align and s.pre_align_after_rnn:  # `SDNet.py:330-336`
            ocr_long = [self.pre_align(ocr_input, q_word_emb, q_mask)]
            od_long = [self.pre_align(od_input, q_word_emb, q_mask)]
        else:
            ocr_long, od_long = [ocr_input], [od_input]

        _, ocr_layers = self.context_rnn(ocr_input, ln=True, return_list=True)
        _, q_layers = self.ques_rnn(q_input, ln=True, return_list=True)
        _, od_layers = self.context_rnn(od_input, ln=True, return_list=True)
        q_highlvl = self.high_lvl_ques_rnn(torch.cat(q_layers, dim=2), ln=True)
        q_all = list(q_layers) + [q_highlvl]

        ocr_after, ocr_inter = self.deep_attn(
            ocr_long, ocr_layers, [q_word_emb], q_all, ocr_mask, q_mask
        )
        od_after, od_inter = self.deep_attn(
            od_long, od_layers, [q_word_emb], q_all, od_mask, q_mask
        )

        if s.no_context_self_attention:
            ocr_highlvl = self.high_lvl_context_rnn(ocr_after, ln=True)
            od_highlvl = self.high_lvl_context_rnn(od_after, ln=True)
        else:
            ocr_self_in = torch.cat([ocr_after, ocr_inter, ocr_input], dim=2)
            od_self_in = torch.cat([od_after, od_inter, od_input], dim=2)
            ocr_self = self.highlvl_self_att(
                ocr_self_in, ocr_self_in, ocr_mask, x3=ocr_after
            )
            od_self = self.highlvl_self_att(
                od_self_in, od_self_in, od_mask, x3=od_after
            )
            ocr_highlvl = self.high_lvl_context_rnn(
                torch.cat([ocr_after, ocr_self], dim=2), ln=True
            )
            od_highlvl = self.high_lvl_context_rnn(
                torch.cat([od_after, od_self], dim=2), ln=True
            )

        # position-aware OD -> OCR attention (`SDNet.py:393-403`)
        if s.position_mod == "qk+":
            x_od_ocr = self.od_ocr_attn(ocr_highlvl, od_highlvl, od_mask) + (
                self.position_attn(
                    ocr_position, od_position, od_mask, x3=od_highlvl
                )
            )
        elif s.position_mod == "cat":
            x_od_ocr = self.od_ocr_attn(
                torch.cat([ocr_highlvl, ocr_position], dim=2),
                torch.cat([od_highlvl, od_position], dim=2), od_mask,
            )
        if s.pos_att_merge_mod == "cat":
            ocr_final = torch.cat([ocr_highlvl, x_od_ocr], dim=2)
        elif s.pos_att_merge_mod == "atted":
            ocr_final = x_od_ocr
        else:
            ocr_final = ocr_highlvl

        q_final = self.ques_self_attn(q_highlvl, q_highlvl, q_mask)
        q_merged = weighted_avg(q_final, self.ques_merger(q_final, q_mask))
        if es_post:  # `SDNet.py:418-422`
            es_final = self.ES_ocr_att(self.ES_linear(es_emb), ocr_final,
                                       ocr_mask)
            ocr_final = torch.cat([es_final, ocr_final], dim=-2)
            ocr_mask = torch.cat([es_mask, ocr_mask], dim=-1)
        scores = self.get_answer(
            ocr_final, q_merged, ocr_mask,
            es_len=s.es_ocr_len if s.use_es else None,
            mask_flag=s.mask_score,
        )
        if s.fixed_answers:
            fixed = torch.softmax(self.fixed_ans_classifier(q_merged), dim=-1)
            alpha = self.fixed_ocr_alpha.reshape(())
            scores = torch.cat([alpha * fixed, (1.0 - alpha) * scores], dim=-1)
        return scores


@torch.no_grad()
def install_embeddings(model: RUArtModel, glove=None, fasttext=None,
                       phoc=None) -> RUArtModel:
    """Copy pretrained word-vector tables (numpy or tensors) into the
    model's embeddings (`SDNet.py:51-67`); the shapes must match."""
    for name, table in (("glove_embed", glove), ("fast_embed", fasttext),
                        ("phoc_embed", phoc)):
        if table is None:
            continue
        weight = getattr(model, name).weight
        src = torch.as_tensor(table, dtype=weight.dtype)
        if tuple(src.shape) != tuple(weight.shape):
            raise ValueError(f"{name}: table {tuple(src.shape)} does not fit "
                             f"the embedding {tuple(weight.shape)}")
        weight.copy_(src)
    return model
