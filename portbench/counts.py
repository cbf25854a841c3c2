"""Operations and bytes, counted from shapes: the model's FLOPs per batch
and K1's operations and bytes per call.

Model FLOPs are the ones the plain reference needs for a batch, counted
from unpadded shapes of the reference's own collated batch (numpy blocks
``q``, ``ocr``, ``od`` of ``portbench.reference.collate.Collator``):

* BERT, forward: every encoder row the batch sends (the packed table
  ``bert_packed`` with its segments, else the unique table ``bert_unique``,
  else the dense ``bert`` grid), counting only real tokens. Per layer a
  token costs ``2 D (4 D + 2 F)`` (Q, K, V, output projection, FFN) and
  each pair of tokens of one segment ``4 D`` (Q K^T and P V); the pooler
  ``2 D^2`` per row. Embedding lookups, softmax, LayerNorm and GELU are
  not counted.
* LSTMs, forward: ``2 * 4H (I + H)`` per real time step, layer and
  direction (the input and the recurrent product), over the real lengths
  of what each stack reads: candidate words (``multi2one``), candidates
  per item (``context_rnn``, ``high_lvl_context_rnn``, OCR and OD), and
  question words (``ques_rnn``, ``high_lvl_ques_rnn``).
* The fusion stack's other products, forward (:func:`fusion_flops`): each
  ``Attention`` costs ``2 h in`` per vector projected on either side and
  ``2 (h + v)`` per pair of attended vectors (score and weighted sum); the
  pairs are those of one item: candidate words with question words
  (pre-align), candidates with question words (deep attention), candidates
  with candidates (self-attention), OCR with OD candidates, question words
  with question words; then the question merge and the scorer's bilinear
  heads. :func:`fusion_sizes` reads the real sizes of a batch. The
  pooling of each word's pieces (a mean, written as a matmul in the model)
  is not counted.

A training step adds the backward of the part that trains, twice its
forward: the fusion stack's LSTMs and products (BERT is locked under
LOCK_BERT and runs without a graph).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

BLOCKS = ("q", "ocr", "od")


def bert_rows(block: Dict[str, np.ndarray]) -> Tuple[int, int, int]:
    """(real tokens, sum over segments of length squared, rows) of the
    encoder rows one collated block sends to BERT."""
    if "bert_packed" in block:
        ids, seg = block["bert_packed"], block["bert_packed_seg"]
        rows = int((ids != 0).any(axis=1).sum())
        real = seg > 0
        tokens = int(real.sum())
        # segment lengths: counts of each (row, segment id) among real tokens
        keys = np.nonzero(real)[0] * (seg.max() + 1) + seg[real]
        _, lens = np.unique(keys, return_counts=True)
        return tokens, int((lens.astype(np.int64) ** 2).sum()), rows
    if "bert_unique" in block:
        ids = block["bert_unique"]
    else:
        ids = block["bert"].reshape(-1, block["bert"].shape[-1])
    lens = (ids != 0).sum(axis=1).astype(np.int64)
    return int(lens.sum()), int((lens ** 2).sum()), int((lens > 0).sum())


def bert_flops(blocks: Iterable[Dict[str, np.ndarray]], hidden: int,
               ffn: int, layers: int) -> float:
    D, F = hidden, ffn
    tokens = pairs = rows = 0
    for block in blocks:
        t, p, r = bert_rows(block)
        tokens, pairs, rows = tokens + t, pairs + p, rows + r
    per_layer = tokens * 2 * D * (4 * D + 2 * F) + pairs * 4 * D
    return float(layers * per_layer + rows * 2 * D * D)


def lstm_step_flops(input_size: int, hidden: int) -> int:
    return 2 * 4 * hidden * (input_size + hidden)


def stack_flops(stack, steps: int) -> float:
    """FLOPs of one StackedBRNN over ``steps`` real time steps in all."""
    total = 0
    for i in range(stack.num_layers):
        lstm = getattr(stack, f"rnn_{i}")
        dirs = 2 if lstm.bidirectional else 1
        total += dirs * lstm_step_flops(lstm.input_size, lstm.hidden_size)
    return float(total * steps)


def lengths(block: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """(candidates, candidate words) of a candidate block, real only."""
    num = np.asarray(block["num"]).astype(np.int64)
    lens = np.asarray(block["len"]).astype(np.int64)
    N = lens.shape[1]
    keep = np.arange(N)[None, :] < num[:, None]
    return int(num.sum()), int((lens * keep).sum())


def question_words(q: Dict[str, np.ndarray]) -> int:
    key = "fasttext" if "fasttext" in q else "glove"
    return int((np.asarray(q[key]) != 0).sum())


def lstm_flops(model, q, ocr, od) -> float:
    """Forward FLOPs of the fusion stack's LSTMs (``model``: the
    reference ``RUArtModel``, read for its stacks' widths)."""
    n_ocr, w_ocr = lengths(ocr)
    n_od, w_od = lengths(od)
    wq = question_words(q)
    return (stack_flops(model.multi2one, w_ocr + w_od)
            + stack_flops(model.context_rnn, n_ocr + n_od)
            + stack_flops(model.deep_attn.rnn, n_ocr + n_od)
            + stack_flops(model.high_lvl_context_rnn, n_ocr + n_od)
            + stack_flops(model.ques_rnn, wq)
            + stack_flops(model.high_lvl_ques_rnn, wq))


def fusion_sizes(q, ocr, od) -> Dict[str, np.ndarray]:
    """Per item: question words, OCR and OD candidates and their words
    (real only)."""
    key = "fasttext" if "fasttext" in q else "glove"
    out = {"q": (np.asarray(q[key]) != 0).sum(axis=1).astype(np.int64)}
    for name, block in (("ocr", ocr), ("od", od)):
        num = np.asarray(block["num"]).astype(np.int64)
        lens = np.asarray(block["len"]).astype(np.int64)
        keep = np.arange(lens.shape[1])[None, :] < num[:, None]
        out[name] = num
        out[name + "_words"] = (lens * keep).sum(axis=1)
    return out


def attention_flops(module, n1, n2, pairs, values: int) -> float:
    """One ``layers.Attention`` call: ``n1`` and ``n2`` vectors projected,
    ``pairs`` scored and summed over ``values``-wide values."""
    lin = module.scoring.linear
    h, d_in = lin.out_features, lin.in_features
    return float(2 * h * d_in * (n1 + n2) + 2 * (h + values) * pairs)


def fusion_flops(model, s: Dict[str, np.ndarray]) -> float:
    """Forward FLOPs of the fusion stack's products but the LSTMs, for the
    sizes ``s`` (:func:`fusion_sizes`; any per-item sizes of that form)."""
    spec = model.spec
    q = s["q"]
    total = 0.0
    att = model.deep_attn
    values = [2 * spec.hidden_size] * spec.in_rnn_layers + [spec.ques_final_size]
    for name in ("ocr", "od"):
        n, words = s[name], s[name + "_words"]
        total += attention_flops(model.pre_align, words.sum(), q.sum(),
                                 (words * q).sum(), model.pre_align.scoring.linear.in_features)
        for i, v in enumerate(values[:att.levels]):
            total += attention_flops(getattr(att, f"int_attn_{i}"), n.sum(),
                                     q.sum(), (n * q).sum(), v)
        total += attention_flops(model.highlvl_self_att, n.sum(), n.sum(),
                                 (n * n).sum(), 2 * spec.highlvl_hidden_size)
    pairs = (s["ocr"] * s["od"]).sum()
    ctx = 2 * spec.highlvl_hidden_size
    total += attention_flops(model.od_ocr_attn, s["ocr"].sum(), s["od"].sum(),
                             pairs, ctx)
    total += attention_flops(model.position_attn, s["ocr"].sum(),
                             s["od"].sum(), pairs, ctx)
    qf = spec.ques_final_size
    total += attention_flops(model.ques_self_attn, q.sum(), q.sum(),
                             (q * q).sum(), qf)
    total += 4.0 * qf * q.sum()       # ques_merger's scores, weighted sum
    ga, x = model.get_answer, spec.ocr_final_size
    items, cands = len(q), s["ocr"].sum()
    heads = 1 + int(ga.use_es)
    total += heads * 2.0 * qf * x * items + 2.0 * x * cands
    if ga.no_answer:
        total += 2.0 * qf * x * items + 4.0 * x * cands + 2.0 * x * items
    return float(total)


def model_flops(model, batch, train: bool) -> Dict[str, float]:
    """{'bert': FLOPs in the encoder's precision, 'fp32': FLOPs in fp32}
    of one collated batch (q, ocr, od, ...)."""
    q, ocr, od = batch[:3]
    c = model.spec.bert
    bert = bert_flops((q, ocr, od), c.hidden_size, c.intermediate_size,
                      c.num_hidden_layers)
    fusion = lstm_flops(model, q, ocr, od) + fusion_flops(
        model, fusion_sizes(q, ocr, od))
    return {"bert": bert, "fp32": fusion * (3 if train else 1)}


def k1_call(rows: int, length: int, width: int, elt_bytes: int,
            bias_dim: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one K1 call on [rows, length, width] q/k/v:
    Q K^T and P V over every query and key of a row (4 L^2 D per row), and
    each input read once (q, k, v, the fp32 bias) and the output written
    once."""
    flops = 4.0 * rows * length * length * width
    bias = rows * length * (length if bias_dim == 3 else 1) * 4
    nbytes = 4.0 * rows * length * width * elt_bytes + bias
    return flops, float(nbytes)
