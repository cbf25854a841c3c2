"""Data-path debug scan (the reference's DEBUG mode) — copy of
``ruart_tpu/data/debug.py``.

``'DEBUG' in opt`` makes the reference trainer iterate every split through
the Dataset/Sampler/DataLoader without touching the model and dump length
histograms (`SDNetTrainer.py:67-79`, `VQA_Dataset.debug_dataset:72-103`).
:func:`scan_dataset` reproduces the artifact: per-field length histograms
written as ``<split>_{q,ocr,od}_output.json``.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict

from ruart_tpu_torch.data.dataset import VQADataset


def scan_dataset(dataset: VQADataset) -> Dict[str, Dict]:
    q_hist = {"glove_len": Counter(), "bert_len": Counter(),
              "ocr_num": Counter(), "od_num": Counter()}
    ocr_hist = {"glove_len": Counter(), "bert_len": Counter()}
    od_hist = {"glove_len": Counter(), "bert_len": Counter()}
    for i in range(len(dataset)):
        item = dataset[i]
        q = item["q"]
        q_hist["glove_len"][len(q["glove"])] += 1
        if "bert" in q:
            q_hist["bert_len"][len(q["bert"])] += 1
        q_hist["ocr_num"][len(item["ocr"])] += 1
        q_hist["od_num"][len(item["od"])] += 1
        for block, hist in ((item["ocr"], ocr_hist), (item["od"], od_hist)):
            for cand in block:
                key = "fasttext" if "fasttext" in cand else "glove"
                hist["glove_len"][len(cand[key])] += 1
                if "bert" in cand:
                    hist["bert_len"][len(cand["bert"])] += 1
    to_plain = lambda h: {k: dict(sorted(v.items())) for k, v in h.items()}
    return {"q": to_plain(q_hist), "ocr": to_plain(ocr_hist), "od": to_plain(od_hist)}


def dump_debug_scan(dataset: VQADataset, split: str, out_dir: str = "."):
    hists = scan_dataset(dataset)
    paths = []
    for name in ("q", "ocr", "od"):
        path = os.path.join(out_dir, f"{split}_{name}_output.json")
        with open(path, "w") as f:
            json.dump(hists[name], f, indent=2)
        paths.append(path)
    return paths
