"""Synthetic fixed-shape batches and raw datasets — copy of
``ruart_tpu/data/synthetic.py``.

* :func:`make_synthetic_batch` — a random, structurally valid model batch
  (serving warmup builds its batch signatures from it, so its arrays are
  byte-equal to the JAX package's for the same seed).
* :func:`make_synthetic_raw_dataset` — a small raw dataset in the
  reference's pre-preprocessing schema (`Utils/CoQAPreprocess.py:160-264`
  consumes this shape), so the serving and training paths can run end to
  end without the proprietary ST-VQA data.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.fusion.spec import ModelSpec


def _cand_block(
    rng: np.random.RandomState,
    B: int,
    N: int,
    L: int,
    Lb: int,
    vocab: int,
    bert_vocab: int,
    pos_vocab: int,
    ent_vocab: int,
    min_num: int = 1,
) -> Dict[str, np.ndarray]:
    num = rng.randint(min_num, N + 1, size=(B,)).astype(np.int32)
    lens = np.zeros((B, N), dtype=np.int32)
    out = {
        "fasttext": np.zeros((B, N, L), dtype=np.int32),
        "glove": np.zeros((B, N, L), dtype=np.int32),
        "pos": np.zeros((B, N, L), dtype=np.int32),
        "ent": np.zeros((B, N, L), dtype=np.int32),
        "bert": np.zeros((B, N, Lb), dtype=np.int32),
        "bert_offsets": np.zeros((B, N, L, 2), dtype=np.int32),
        "position": rng.rand(B, N, 8).astype(np.float32),
        "num": num,
        "len": lens,
    }
    for b in range(B):
        for n in range(num[b]):
            w = rng.randint(1, L + 1)
            lens[b, n] = w
            ids = rng.randint(5, vocab, size=w)
            out["fasttext"][b, n, :w] = ids
            out["glove"][b, n, :w] = ids
            out["pos"][b, n, :w] = rng.randint(0, pos_vocab, size=w)
            out["ent"][b, n, :w] = rng.randint(0, ent_vocab, size=w)
            # bert: [CLS] pieces [SEP]; ~1 piece per word, clipped to Lb-2
            n_pieces = min(w, Lb - 2)
            out["bert"][b, n, 0] = 2
            out["bert"][b, n, 1 : 1 + n_pieces] = rng.randint(
                5, bert_vocab, size=n_pieces
            )
            out["bert"][b, n, 1 + n_pieces] = 3
            for j in range(w):
                st = 1 + min(j, n_pieces - 1)
                out["bert_offsets"][b, n, j] = (st, st + 1)
        out["position"][b, num[b]:] = 0.0
    out["bert_mask"] = (out["bert"] != 0).astype(np.int32)
    return out


def make_synthetic_batch(
    spec: ModelSpec,
    cfg: Config,
    batch_size: int,
    seed: int = 0,
    bert_vocab: Optional[int] = None,
    ocr_num: Optional[int] = None,
    ocr_bert_len: Optional[int] = None,
    q_bert_len: Optional[int] = None,
    ocr_word_len: Optional[int] = None,
    od_word_len: Optional[int] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any], np.ndarray]:
    """Random (q, ocr, od, targets) with the conf's fixed shapes.
    The keyword overrides replace individual shape caps (used to warm up
    length-bucket signatures — `serve.InferenceEngine.warmup`)."""
    rng = np.random.RandomState(seed)
    B = batch_size
    bert_vocab = bert_vocab or (spec.bert.vocab_size if spec.bert else 100)
    vocab = max(spec.vocab_size, 6)
    Lq, Lqb = cfg.max_q_len, q_bert_len or cfg.max_q_bert_len

    q: Dict[str, Any] = {
        "glove": np.zeros((B, Lq), dtype=np.int32),
        "fasttext": np.zeros((B, Lq), dtype=np.int32),
        "pos": np.zeros((B, Lq), dtype=np.int32),
        "ent": np.zeros((B, Lq), dtype=np.int32),
        "bert": np.zeros((B, Lqb), dtype=np.int32),
        "bert_offsets": np.zeros((B, Lq, 2), dtype=np.int32),
    }
    for b in range(B):
        w = rng.randint(3, Lq + 1)
        ids = rng.randint(5, vocab, size=w)
        q["glove"][b, :w] = ids
        q["fasttext"][b, :w] = ids
        q["pos"][b, :w] = rng.randint(0, spec.pos_vocab, size=w)
        q["ent"][b, :w] = rng.randint(0, spec.ent_vocab, size=w)
        n_pieces = min(w, Lqb - 2)
        q["bert"][b, 0] = 2
        q["bert"][b, 1 : 1 + n_pieces] = rng.randint(5, bert_vocab, size=n_pieces)
        q["bert"][b, 1 + n_pieces] = 3
        for j in range(w):
            st = 1 + min(j, n_pieces - 1)
            q["bert_offsets"][b, j] = (st, st + 1)
    q["bert_mask"] = (q["bert"] != 0).astype(np.int32)

    min_ocr = (spec.es_ocr_len + 1) if spec.use_es else 1
    n_ocr = ocr_num or cfg.max_ocr_num
    ocr = _cand_block(
        rng, B, n_ocr, ocr_word_len or cfg.max_ocr_len,
        ocr_bert_len or cfg.max_ocr_bert_len,
        vocab, bert_vocab, spec.pos_vocab, spec.ent_vocab,
        min_num=min(min_ocr, n_ocr),
    )
    od = _cand_block(
        rng, B, cfg.max_od_num, od_word_len or cfg.max_od_len,
        cfg.max_od_bert_len,
        vocab, bert_vocab, spec.pos_vocab, spec.ent_vocab,
    )
    n_scores = (
        spec.fixed_answers_len
        + (3 if spec.label_yesno else 0)
        + cfg.max_ocr_num
        + (1 if spec.label_no_answer else 0)
    )
    targets = np.zeros((B, n_scores), dtype=np.float32)
    for b in range(B):
        targets[b, rng.randint(0, n_scores)] = 1.0
    if spec.img_feature:
        q["img_features"] = rng.rand(B, spec.img_fea_num, spec.img_fea_dim).astype(
            np.float32
        )
        q["img_spatials"] = rng.rand(B, spec.img_fea_num, 8).astype(np.float32)
    return q, ocr, od, targets


# ---------------------------------------------------------------------------
# Raw dataset (reference input schema) for end-to-end pipeline tests
# ---------------------------------------------------------------------------

_WORDS = [
    "stop", "exit", "sale", "open", "coffee", "pizza", "hotel", "museum",
    "street", "north", "south", "market", "plaza", "little", "big", "red",
    "blue", "store", "bank", "school", "2019", "42", "7", "main", "first",
]
_OBJECTS = ["sign", "car", "building", "person", "tree", "bus", "window", "door"]
_TEMPLATES = [
    "what is written on the {obj}",
    "what does the {obj} say",
    "what is the name on the {obj}",
    "what number is on the {obj}",
]


def make_synthetic_raw_dataset(
    n: int,
    seed: int = 0,
    ocr_name: str = "ocr_PMTD_ASTER",
    od_name: str = "OD_bottom-up",
    es_name: str = "ES_ocr",
    n_ocr_range: Tuple[int, int] = (2, 8),
    n_od_range: Tuple[int, int] = (1, 4),
    n_es: int = 10,
    with_answers: bool = True,
) -> Dict[str, Any]:
    """A raw dataset dict shaped like the reference's msgpack input:
    each datum has question/question_id/file_path/image dims, OCR entries
    {'word', 'pos' (8-dim quad px)}, ES entries with 'cnt', and OD entries
    {'object', 'pos' (center x,y,w,h px)}. The answer is one OCR word so a
    trained model can actually fit it."""
    rng = np.random.RandomState(seed)
    data = []
    for i in range(n):
        W, H = int(rng.randint(300, 1000)), int(rng.randint(300, 1000))
        n_ocr = int(rng.randint(*n_ocr_range))
        words = [str(rng.choice(_WORDS)) for _ in range(n_ocr)]
        ocr = []
        for w in words:
            x0, y0 = rng.randint(0, W // 2), rng.randint(0, H // 2)
            bw, bh = rng.randint(10, W // 2), rng.randint(5, H // 4)
            ocr.append(
                {
                    "word": w,
                    "pos": [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh],
                }
            )
        es = []
        for j in range(n_es):
            w = str(rng.choice(_WORDS))
            x0, y0 = rng.randint(0, W // 2), rng.randint(0, H // 2)
            es.append(
                {
                    "word": w,
                    "pos": [x0, y0, x0 + 30, y0, x0 + 30, y0 + 10, x0, y0 + 10],
                    "cnt": int(rng.randint(1, 50)),
                    "idx": j,
                }
            )
        n_od = int(rng.randint(*n_od_range))
        od = []
        for _ in range(n_od):
            cx, cy = rng.randint(50, W - 50), rng.randint(50, H - 50)
            bw, bh = rng.randint(10, min(cx, W - cx)), rng.randint(10, min(cy, H - cy))
            od.append({"object": str(rng.choice(_OBJECTS)), "pos": [cx, cy, bw, bh]})
        obj = od[0]["object"] if od else "sign"
        question = str(rng.choice(_TEMPLATES)).format(obj=obj)
        answer = words[int(rng.randint(0, len(words)))] if words else "unanswerable"
        datum = {
            "question": question,
            "question_id": i,
            "file_path": f"img_{i}.jpg",
            "image_width": W,
            "image_height": H,
            ocr_name: ocr,
            es_name: es,
            od_name: od,
        }
        if with_answers:
            datum["answers"] = [answer] * int(rng.choice([1, 10]))
        data.append(datum)
    return {"data": data}
