"""Synthetic raw datasets.

:func:`make_synthetic_raw_dataset` builds a small raw dataset in the
reference's pre-preprocessing schema (`Utils/CoQAPreprocess.py:160-264`
consumes this shape), so the serving path can run end to end without the
proprietary ST-VQA data. Copy of the function of the same name in
``ruart_tpu/data/synthetic.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


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
