"""The seeded generator of scene-text questions: the one generator every
traffic mix reads its parameters into.

An item has the schema of the reference's raw ST-VQA input (what the
port's ``data/preprocess.py`` consumes): a question from a template about
one of the detected objects, the image size, OCR words with 8-number quads
in pixels, ES candidates (words with quads and counts) and OD objects
(label and centre box). Training items carry 1 or more answers, each one
of the item's OCR words. It follows ``ruart_tpu_torch/data/synthetic.py::
make_synthetic_raw_dataset`` (the repo's bench corpus), with every size a
parameter and numpy's seeded ``Generator`` in place of ``RandomState``, so
that any whole-number seed works.

Parameters (``corpus`` in a mix's file; defaults in :data:`DEFAULTS`):
``ocr_words`` and ``od_objects`` are inclusive [low, high] counts per
item, ``es_words`` a count, ``answers`` an inclusive range (training
only), ``image_px`` the inclusive range of each image side, ``lexicon``
the number of distinct words OCR and ES words are drawn from, ``zipf``
the exponent of their frequencies (the word of rank r drawn with weight
1 / r ** zipf; 0 draws them uniformly), and ``corpus_seed`` (optional)
the seed of the items themselves.

The lexicon (:func:`lexicon`) is the same for every seed and mix: the
generator's own 25 words (:data:`WORDS`), then letter and digit strings
of scene-text lengths from one fixed stream. The defaults, 25 words drawn
uniformly, are the repo's bench corpus. A mix that sets a lexicon of the
size of a real dictionary (ST-VQA's weakly contextualised task has one of
30,000 words) gets a word vocabulary of thousands of words and batches
whose candidate strings rarely repeat.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

WORDS = [
    "stop", "exit", "sale", "open", "coffee", "pizza", "hotel", "museum",
    "street", "north", "south", "market", "plaza", "little", "big", "red",
    "blue", "store", "bank", "school", "2019", "42", "7", "main", "first",
]
OBJECTS = ["sign", "car", "building", "person", "tree", "bus", "window", "door"]
TEMPLATES = [
    "what is written on the {obj}",
    "what does the {obj} say",
    "what is the name on the {obj}",
    "what number is on the {obj}",
]
DEFAULTS = {
    "ocr_words": [15, 30], "od_objects": [10, 30], "es_words": 40,
    "answers": [1, 2], "image_px": [300, 999], "lexicon": len(WORDS), "zipf": 0.0,
}
OCR_NAME, OD_NAME, ES_NAME = "ocr_PMTD_ASTER", "OD_bottom-up", "ES_ocr"


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for sub-stream ``stream`` of ``seed`` (any whole
    number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def lexicon(n: int) -> np.ndarray:
    """The ``n`` words of the lexicon, most frequent first: :data:`WORDS`,
    then distinct strings of 3-8 letters (one in ten of 1-4 digits) from a
    stream that no seed changes."""
    rng = rng_for(0, 7)
    words = list(dict.fromkeys(WORDS))[:n]
    seen = set(words)
    while len(words) < n:
        k = 2 * (n - len(words)) + 16
        length = rng.integers(3, 9, size=k)
        codes = rng.integers(ord("a"), ord("z") + 1, size=(k, 8), dtype=np.uint8)
        number = rng.integers(0, 10 ** rng.integers(1, 5, size=k))
        digits = rng.random(k) < 0.1
        for i in range(k):
            w = (str(number[i]) if digits[i]
                 else codes[i, :length[i]].tobytes().decode())
            if w not in seen and len(words) < n:
                seen.add(w)
                words.append(w)
    return np.array(words)


def make_items(n: int, seed: int, params: Dict[str, Any] | None = None,
               with_answers: bool = False) -> List[Dict[str, Any]]:
    """``n`` raw items for ``seed``. With ``corpus_seed`` in ``params``
    every seed gets the same items (drawn from ``corpus_seed``) in an order
    of its own, so that the seed changes which items share a batch or a
    wave but not the work of the set."""
    p = dict(DEFAULTS, **(params or {}))
    if p.get("corpus_seed") is not None:
        items = _draw(n, int(p["corpus_seed"]), p, with_answers)
        order = rng_for(seed, 3).permutation(n)
        return [dict(items[i], question_id=k, file_path=f"img_{k}.jpg")
                for k, i in enumerate(order)]
    return _draw(n, seed, p, with_answers)


def _draw(n: int, seed: int, p: Dict[str, Any], with_answers: bool):
    rng = rng_for(seed, 1)
    words, objects = lexicon(int(p["lexicon"])), np.array(OBJECTS)
    if float(p["zipf"]) > 0:
        weights = 1.0 / np.arange(1, len(words) + 1) ** float(p["zipf"])
        cdf = np.cumsum(weights / weights.sum())

        def draw(k):
            return words[np.minimum(np.searchsorted(cdf, rng.random(k)),
                                    len(words) - 1)].tolist()
    else:
        def draw(k):
            return words[rng.integers(0, len(words), size=k)].tolist()

    lo_px, hi_px = p["image_px"]
    data = []
    for i in range(n):
        W, H = (int(x) for x in rng.integers(lo_px, hi_px + 1, size=2))
        n_ocr = int(rng.integers(p["ocr_words"][0], p["ocr_words"][1] + 1))
        x0 = rng.integers(0, W // 2, size=n_ocr)
        y0 = rng.integers(0, H // 2, size=n_ocr)
        bw = rng.integers(10, W // 2, size=n_ocr)
        bh = rng.integers(5, H // 4, size=n_ocr)
        ocr_words = draw(n_ocr)
        ocr = [{"word": w, "pos": [int(a), int(b), int(a + c), int(b),
                                   int(a + c), int(b + d), int(a), int(b + d)]}
               for w, a, b, c, d in zip(ocr_words, x0, y0, bw, bh)]
        n_es = int(p["es_words"])
        ex = rng.integers(0, W // 2, size=n_es)
        ey = rng.integers(0, H // 2, size=n_es)
        cnt = rng.integers(1, 50, size=n_es)
        es_words = draw(n_es)
        es = [{"word": w, "pos": [int(a), int(b), int(a) + 30, int(b),
                                  int(a) + 30, int(b) + 10, int(a), int(b) + 10],
               "cnt": int(c), "idx": j}
              for j, (w, a, b, c) in enumerate(zip(es_words, ex, ey, cnt))]
        n_od = int(rng.integers(p["od_objects"][0], p["od_objects"][1] + 1))
        cx = rng.integers(50, W - 50, size=n_od)
        cy = rng.integers(50, H - 50, size=n_od)
        ow = rng.integers(10, np.maximum(11, np.minimum(cx, W - cx))).tolist()
        oh = rng.integers(10, np.maximum(11, np.minimum(cy, H - cy))).tolist()
        od_names = objects[rng.integers(0, len(objects), size=n_od)].tolist()
        od = [{"object": o, "pos": [int(a), int(b), c, d]}
              for o, a, b, c, d in zip(od_names, cx, cy, ow, oh)]
        obj = od[0]["object"] if od else "sign"
        question = TEMPLATES[int(rng.integers(0, len(TEMPLATES)))].format(obj=obj)
        datum = {
            "question": question, "question_id": i,
            "file_path": f"img_{i}.jpg", "image_width": W, "image_height": H,
            OCR_NAME: ocr, ES_NAME: es, OD_NAME: od,
        }
        if with_answers:
            k = int(rng.integers(p["answers"][0], p["answers"][1] + 1))
            datum["answers"] = [ocr_words[int(j)] for j in
                                rng.integers(0, n_ocr, size=k)]
        data.append(datum)
    return data
