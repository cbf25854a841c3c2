"""Runtime dataset: preprocessed datum -> ragged per-item features.

Equivalent of `Utils/VQA_Dataset.py`: items come out as plain python/numpy
structures which :mod:`ruart_tpu_torch.data.collate` packs into fixed-shape
batches. Copy of ``ruart_tpu/data/dataset.py``; the image-feature providers
are in :mod:`ruart_tpu_torch.data.image_features`.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.image_features import HDF5ImageFeatures
from ruart_tpu_torch.eval.metrics import note_stvqa, note_textvqa
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer

log = logging.getLogger(__name__)

OCR_END_ITEM = {
    "word": {"word": ["<OCR>"], "wordid": [3], "pos_id": [0], "ent_id": [0]},
    "pos": [0.0] * 8,
    "original": "<OCR>",
    "ANLS": 0.0,
    "ACC": 0.0,
}
OD_END_ITEM = {
    "word": {"word": ["<OD>"], "wordid": [4], "pos_id": [0], "ent_id": [0]},
    "pos": [0.0] * 8,
    "original": "<OD>",
    "ANLS": 0.0,
    "ACC": 0.0,
}


class VQADataset:
    """Filters, candidate-list assembly, per-item ids and labels
    (`VQA_Dataset.py:13-436`)."""

    def __init__(
        self,
        data: Sequence[dict],
        cfg: Config,
        mode: str = "train",
        tokenizer: Optional[WordPieceTokenizer] = None,
        fixed_answers_entry: Optional[dict] = None,
        image_features=None,
    ):
        assert mode in ("train", "dev", "test")
        self.cfg = cfg
        self.opt = cfg.opt
        self.mode = mode
        self.tokenizer = tokenizer
        self.fixed_answers_entry = fixed_answers_entry
        self.image_features = image_features

        self.data: List[dict] = []
        dropped = []
        for datum in data:
            if len(datum["annotated_question"]["word"]) == 0:
                dropped.append(datum["question_id"])
                continue
            if mode != "test" and len(datum.get("orign_answers", [])) == 0:
                dropped.append(datum["question_id"])
                continue
            self.data.append(datum)
        if dropped:
            log.info(
                "Removed %d samples for empty question or answers: %s",
                len(dropped), dropped[:20],
            )

        self.ocr_name_list = str(self.opt["ocr_name_list"]).split(",")
        self.od_name_list = str(self.opt["od_name_list"]).split(",")
        self.q_embedding = cfg.q_embedding
        self.ocr_embedding = cfg.ocr_embedding
        self._emb_names = frozenset(self.q_embedding) | frozenset(
            self.ocr_embedding
        )
        self.score_name = self.opt["score_name"]
        self._es_cache: Dict[int, list] = {}
        if "ES_ocr" in self.opt:
            self.ocr_name_list = [self.opt["ES_ocr"]] + self.ocr_name_list
            self.es_ocr_len = int(self.opt["ES_ocr_len"])
            self.es_sort_way = self.opt["ES_sort_way"]

    def __len__(self) -> int:
        return len(self.data)

    # ------------------------------------------------------------------
    def get_list_from_datum(
        self, datum: dict, name_list: Sequence[str], od_ocr: str
    ) -> List[dict]:
        """Merge candidate sources, ES sort/truncate, optional dedupe,
        sentinel append (`VQA_Dataset.py:295-351`)."""
        assert od_ocr in ("od", "ocr")
        remove_same = "remove_same" in self.opt
        es_name = self.opt.get("ES_ocr") if "ES_ocr" in self.opt else None
        word_key = "object" if od_ocr == "od" else "word"
        score_name = self.score_name
        seen: Dict[str, int] = {}
        res: List[dict] = []
        for name in name_list:
            is_es = es_name is not None and name == es_name
            if is_es:
                # ES sort/truncate is deterministic per datum — cache it so
                # repeated passes (epochs, eval cadence) skip the sort
                items = self._es_cache.get(id(datum))
                if items is None:
                    items = list(datum.get(name, []))
                    if self.es_sort_way == "frequency":
                        items.sort(key=lambda x: x.get("cnt", 0), reverse=True)
                    elif self.es_sort_way == "relevance":
                        items.sort(key=lambda x: x.get("idx", 0))
                    else:
                        raise ValueError("es_sort_way is wrong")
                    items = items[: self.es_ocr_len]
                    self._es_cache[id(datum)] = items
            else:
                items = datum.get(name, ())
            for item in items:
                word = item[word_key]
                if len(word["word"]) == 0:
                    continue
                key = item["original"].lower()
                # minimal entry: exactly the keys downstream consumers read
                # (embedding build, position pack, label build, decode list)
                entry = {"word": word, "original": key, "pos": item["pos"]}
                if score_name in item:
                    entry[score_name] = item[score_name]
                    other = "ACC" if score_name == "ANLS" else "ANLS"
                    if other in item:
                        entry[other] = item[other]
                if is_es:
                    res.append(entry)
                    continue
                if remove_same and key in seen:
                    continue
                seen[key] = 1
                res.append(entry)
        cap = self.cfg.max_od_num if od_ocr == "od" else self.cfg.max_ocr_num
        if len(res) >= cap - 1:
            res = res[: cap - 1]
        res.append(dict(OD_END_ITEM if od_ocr == "od" else OCR_END_ITEM))
        return res

    # ------------------------------------------------------------------
    def bertify(self, words):
        if self.tokenizer is None:
            return None, None
        return self.tokenizer.bertify(words)

    def get_item_embedding(
        self, word: dict, original: str, position=None
    ) -> Dict[str, Any]:
        """Per-item id features (`VQA_Dataset.py:355-398`). ``position``
        is folded in here so the caller doesn't pay a second per-candidate
        dict merge."""
        res: Dict[str, Any] = {}
        if position is not None:
            res["position"] = position
        names = self._emb_names
        # id lists are shared by reference: every downstream consumer
        # (collate packing, label build) reads them without mutating
        if "fasttext" in names:
            res["fasttext"] = word["wordid"]
        if "phoc" in names:
            res["phoc"] = word["wordid"]
        if "glove" in names:
            res["glove"] = word["wordid"]
        if "pos" in names:
            res["pos"] = word["pos_id"]
        if "ent" in names:
            res["ent"] = word["ent_id"]
        if "bert" in self.q_embedding:
            ids, offsets = self.bertify(word["word"])
            res["bert"] = ids
            res["bert_offsets"] = offsets
        if "bert_only" in self.q_embedding:
            ids, _ = self.bertify(original)
            res["bert_only"] = ids
        return res

    # ------------------------------------------------------------------
    def get_label(self, ocr_list: List[dict], answers) -> Optional[List[float]]:
        """Soft labels with the 4 lable_way policies + no-answer bit
        (`VQA_Dataset.py:211-292`). Returns the raw (unpadded) label list;
        collate pads to the fixed width."""
        if self.score_name not in ocr_list[0]:
            return None
        gt = [float(t[self.score_name]) for t in ocr_list]
        if "label_yesno" in self.opt:
            note = note_stvqa if self.score_name == "ANLS" else note_textvqa
            gt = [
                note(answers, "answering does not require reading text in the image"),
                note(answers, "yes"),
                note(answers, "no"),
            ] + gt
        if self.fixed_answers_entry is not None and "fixed_answers" in self.opt:
            fixed_gt = self.fixed_answers_entry["fixed_answers_label"].get(
                "labels", []
            )
            gt = list(fixed_gt) + gt

        gt_max = max(gt) if gt else -1.0
        gt_max_idx = gt.index(gt_max) if gt else -1

        way = self.opt["lable_way"]
        if way == "lable_all":
            pass
        elif way == "lable_all_with_threshold":
            thr = float(self.opt["score_threshold"])
            gt = [t if t >= thr else 0.0 for t in gt]
        elif way == "lable_one_offical":
            thr = 0.5 if self.score_name == "ANLS" else 0.3
            gt = [
                t if i == gt_max_idx and gt_max >= thr else 0.0
                for i, t in enumerate(gt)
            ]
        elif way == "lable_one":
            gt = [t if i == gt_max_idx else 0.0 for i, t in enumerate(gt)]
        else:
            raise ValueError("lable_way is wrong")

        label = {"values": gt, "no_answer": None}
        if "label_no_answer" in self.opt:
            label["no_answer"] = 1.0 if gt_max < 0.1 else 0.0
        return label

    # ------------------------------------------------------------------
    def __getitem__(self, index: int) -> Dict[str, Any]:
        datum = self.data[index]
        ocr_list = self.get_list_from_datum(datum, self.ocr_name_list, "ocr")
        od_list = self.get_list_from_datum(datum, self.od_name_list, "od")
        ocr_list = ocr_list[: self.cfg.max_ocr_num]
        od_list = od_list[: self.cfg.max_od_num]

        q_ann = datum["annotated_question"]
        q: Dict[str, Any] = {}
        names = self.q_embedding
        if "fasttext" in names or True:  # collate always needs word ids
            q["fasttext"] = q_ann["wordid"]
        q["glove"] = q_ann["wordid"]
        if "pos" in names:
            q["pos"] = q_ann["pos_id"]
        if "ent" in names:
            q["ent"] = q_ann["ent_id"]
        if "bert" in names:
            ids, offsets = self.bertify(q_ann["word"])
            q["bert"] = ids
            q["bert_offsets"] = offsets

        ocr_items = [
            self.get_item_embedding(t["word"], t["original"], t["pos"])
            for t in ocr_list
        ]
        od_items = [
            self.get_item_embedding(t["word"], t["original"], t["pos"])
            for t in od_list
        ]

        if "img_feature" in self.opt and self.image_features is not None:
            # provider duck-typing: HDF5 packs key by question/image id,
            # npy providers key by file path (`VQA_Dataset.py:154-207`)
            if isinstance(self.image_features, HDF5ImageFeatures):
                feat, spa = self.image_features.get(datum["question_id"])
            else:
                feat, spa = self.image_features.get(
                    datum.get("filename", ""), mode=self.mode
                )
            q["img_features"] = feat
            q["img_spatials"] = spa

        answers = datum.get("orign_answers")
        gt = self.get_label(ocr_list, answers)
        extra_info = {
            "q_id": datum["question_id"],
            "answers": answers if answers else None,
            "ocr_list": [t["original"] for t in ocr_list],
            "image_path": datum.get("filename", ""),
        }
        return {
            "q": q,
            "ocr": ocr_items,
            "od": od_items,
            "gt": gt,
            "extra_info": extra_info,
        }
