"""Offline preprocessing and host featurization: raw msgpack ->
preprocessed msgpack + meta, and raw datum -> preprocessed datum.

Copy of ``ruart_tpu/data/preprocess.py`` (itself a rebuild of the reference
pipeline, `Utils/CoQAPreprocess.py:93-477`) with the same file names and
contents, so a feature folder written by one package is read by the other:

raw datum in  : question / question_id / file_path / image_width/height /
                answers / <ocr_name>: [{word, pos(8 px quad), cnt?}] /
                <od_name>: [{object, pos(4 center/size px)}]
preprocessed  : annotated_question {word, pos_id, ent_id, wordid, ...},
                orign_answers, per-source OCR/OD lists with normalized
                boxes, per-candidate ANLS/ACC, synthesized n-gram
                candidates with merged boxes, vocabulary ids


meta          : vocab, char_vocab, glove/fasttext/phoc embedding matrices

As in the JAX package, tokenization and tagging use spaCy's
``en_core_web_sm`` when it loads (:func:`_try_spacy`), else the
deterministic rule-based featurizer (``portbench.reference.featurizer``);
the ``PHOC`` table comes from the native encoder (``text/phoc.py``); and
deterministic hashed word vectors stand in when no GloVe/fastText files
are configured.
"""

from __future__ import annotations

import hashlib
import logging
import os
from collections import Counter
from itertools import chain
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack
import numpy as np

from portbench.reference.config import Config
from portbench.reference.constants import RESERVED_CHARS, RESERVED_WORDS
from portbench.reference import metrics
from portbench.reference import featurizer
from portbench.reference.plain import build_phoc_embedding

log = logging.getLogger(__name__)


def _try_spacy():
    try:
        import spacy  # noqa

        nlp = spacy.load("en_core_web_sm", disable=["parser"])
        for token in nlp("probe"):  # reject broken installs / test stubs
            token.tag_, token.ent_iob_, token.lemma_, token.idx
        return nlp
    except Exception:
        return None


def annotate(text: str, nlp=None) -> Dict[str, List]:
    """Tokenize + tag one string into the reference's 'process' schema
    (`CoQAPreprocess.py:566-599`): word / lemma / pos / pos_id / ent /
    ent_id / offsets / sentences."""
    if nlp is not None:
        doc = nlp(featurizer.pre_proc(text.lower()))
        words, lemmas, pos, pos_ids, ents, ent_ids, offsets = [], [], [], [], [], [], []
        for token in doc:
            words.append(featurizer.normalize_text(token.text))
            lemmas.append(
                token.lemma_ if token.lemma_ != "-PRON-" else token.text.lower()
            )
            pos.append(token.tag_)
            pos_ids.append(featurizer.pos_id(token.tag_))
            ent = "O" if token.ent_iob_ == "O" else f"{token.ent_iob_}-{token.ent_type_}"
            ents.append(ent)
            ent_ids.append(featurizer.ent_id(token.ent_iob_, token.ent_type_))
            offsets.append((token.idx, token.idx + len(token.text)))
        sentences = []
        try:
            idx = 0
            for sent in doc.sents:
                sentences.append((idx, idx + len(sent)))
                idx += len(sent)
        except Exception:
            sentences = [(0, len(words))]
    else:
        words, pos_ids, ent_ids = featurizer.tokenize_tag(text)
        inv_pos = {v: k for k, v in featurizer.POS.items()}
        inv_ent = {v: k for k, v in featurizer.ENT.items()}
        lemmas = list(words)
        pos = [inv_pos.get(p, "") for p in pos_ids]
        ents = [inv_ent.get(e, "O") for e in ent_ids]
        # token offsets over the pre_proc'd text
        processed = featurizer.pre_proc(text.lower())
        offsets = []
        p = 0
        for w in words:
            found = processed.find(w, p)
            if found < 0:
                found = p
            offsets.append((found, found + len(w)))
            p = found + len(w)
        sentences = [(0, len(words))]
    return {
        "word": words,
        "lemma": lemmas,
        "pos": pos,
        "pos_id": pos_ids,
        "ent": ents,
        "ent_id": ent_ids,
        "offsets": offsets,
        "sentences": sentences,
    }


def get_raw_context_offsets(words: Sequence[str], raw_text: str) -> List[tuple]:
    """Token offsets into the raw (unprocessed) text
    (`CoQAPreprocess.get_raw_context_offsets:603-617`)."""
    out = []
    p = 0
    for token in words:
        while p < len(raw_text) and raw_text[p].isspace():
            p += 1
        out.append((p, p + len(token)))
        p += len(token)
    return out


def char2id_sent(
    words: Sequence[str], c2id: Dict[str, int], unk_id: int = 1
) -> List[List[int]]:
    """Per-word char ids with <STA>/<END> brackets (`CoQAUtils.py:127-132`)."""
    sta, end = c2id["<STA>"], c2id["<END>"]
    return [
        [sta] + [c2id.get(c, unk_id) for c in w] + [end] for w in words
    ]


def token2id_sent(
    sent: Sequence[str], w2id: Dict[str, int], unk_id: int = 1
) -> List[int]:
    return [w2id.get(w, unk_id) for w in sent]


def token2id_sent_substring_fallback(
    sent: Sequence[str], w2id: Dict[str, int], unk_id: int = 1
):
    """OOV recovery for OCR garble: try len-1 and len-2 substrings before
    falling back to UNK (`Utils/CoQAUtils.py:89-125`)."""
    ids = []
    for w in sent:
        if w in w2id:
            ids.append(w2id[w])
            continue
        found = None
        wl = len(w)
        for l in (wl - 1, wl - 2):
            if l <= 0:
                break
            for i in range(wl - l + 1):
                sub = w[i : i + l]
                if sub in w2id:
                    found = w2id[sub]
                    break
            if found is not None:
                break
        ids.append(found if found is not None else unk_id)
    return ids


def normalize_ocr_box(pos: Sequence[float], width: int, height: int) -> List[float]:
    """8-dim pixel quad -> [0,1] normalized (`CoQAPreprocess.py:220-222`)."""
    out = list(pos)
    for j in range(4):
        out[2 * j] = out[2 * j] / width
        out[2 * j + 1] = out[2 * j + 1] / height
    return out


_ZERO8 = [0] * 8


def _normalize_boxes_batch(items: Sequence[dict], width: int, height: int):
    """One numpy divide over a datum's 8-dim quads instead of a python
    call per box — bit-identical to :func:`normalize_ocr_box` (same
    float64 divisions). Falls back to the scalar path on ragged input."""
    if not items:
        return []
    try:
        mat = np.array(
            [item.get("pos", _ZERO8) for item in items], dtype=np.float64
        )
        if mat.ndim != 2 or mat.shape[1] != 8:
            raise ValueError
    except ValueError:
        return [
            normalize_ocr_box(item.get("pos", [0] * 8), width, height)
            for item in items
        ]
    mat[:, 0::2] /= width
    mat[:, 1::2] /= height
    return mat.tolist()


def _normalize_boxes_corpus(
    raw: Sequence[dict], ocr_names: Sequence[str]
) -> List[List[list]]:
    """Normalized quads for every (datum, ocr source) group — iteration
    order ``for datum in raw: for name in ocr_names`` — computed with ONE
    vectorized float64 divide over the whole corpus. Bit-identical to
    per-group :func:`_normalize_boxes_batch` (same IEEE per-element
    divisions); groups with non-8-length quads fall back to it."""
    plans: List[tuple] = []  # (items, W, H, fast)
    counts: List[int] = []   # per non-empty fast group
    gw: List[float] = []
    gh: List[float] = []
    total = 0
    for datum in raw:
        W, H = datum["image_width"], datum["image_height"]
        for name in ocr_names:
            items = datum.get(name, [])
            try:
                fast = all(len(it.get("pos", _ZERO8)) == 8 for it in items)
            except TypeError:
                fast = False  # unsized pos: the per-group path decides
            if fast and items:
                counts.append(len(items))
                gw.append(W)
                gh.append(H)
                total += len(items)
            plans.append((items, W, H, fast))
    mats = None
    if total:
        try:
            mat = np.fromiter(
                chain.from_iterable(
                    it.get("pos", _ZERO8)
                    for items, _, _, fast in plans
                    if fast
                    for it in items
                ),
                np.float64,
                total * 8,
            ).reshape(total, 8)
            cnt = np.asarray(counts)
            mat[:, 0::2] /= np.repeat(np.asarray(gw, np.float64), cnt)[:, None]
            mat[:, 1::2] /= np.repeat(np.asarray(gh, np.float64), cnt)[:, None]
            mats = mat.tolist()
        except (TypeError, ValueError):
            mats = None  # non-numeric quad somewhere: per-group fallback
    out: List[List[list]] = []
    k = 0
    for items, W, H, fast in plans:
        if fast and mats is not None:
            out.append(mats[k : k + len(items)])
            k += len(items)
        else:
            out.append(_normalize_boxes_batch(items, W, H))
            if fast:
                k += len(items)
    return out


def od_center_to_quad(pos: Sequence[float], width: int, height: int) -> List[float]:
    """OD (cx, cy, w, h) px -> normalized 4-corner quad
    (`CoQAPreprocess.py:249-259`, including the int() half-size truncation)."""
    cx, cy, w, h = pos
    hw, hh = int(w / 2), int(h / 2)
    quad = [
        cx - hw, cy - hh, cx + hw, cy - hh,
        cx + hw, cy + hh, cx - hw, cy + hh,
    ]
    for j in range(4):
        quad[2 * j] = quad[2 * j] / width
        quad[2 * j + 1] = quad[2 * j + 1] / height
    return quad


def merge_quads(a: Sequence[float], b: Sequence[float]) -> List[float]:
    """Bounding merge of two normalized quads: min over the left/top corner
    coords (idx 0,1,3,4 per reference quirk) and max elsewhere
    (`CoQAPreprocess.py:395-403`)."""
    out = list(a)
    for i in range(8):
        if i in (0, 1, 3, 4):
            out[i] = min(out[i], b[i])
        else:
            out[i] = max(out[i], b[i])
    return out


def hashed_vector(word: str, dim: int) -> np.ndarray:
    """Deterministic pseudo word vector (fallback when no embedding files
    are available in the environment)."""
    seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, dim).astype(np.float32)


def build_glove_embedding(
    embed_file: Optional[str], vocab: Sequence[str], dim: int
) -> np.ndarray:
    """GloVe-text-file embedding matrix; unmatched rows uniform(-1,1), row 0
    zero (`CoQAUtils.py:34-50`). Hashed fallback without a file."""
    rng = np.random.RandomState(0)
    emb = rng.uniform(-1, 1, (len(vocab), dim)).astype(np.float32)
    if embed_file and os.path.isfile(embed_file):
        w2id = {w: i for i, w in enumerate(vocab)}
        with open(embed_file, encoding="utf8") as f:
            for line in f:
                elems = line.split()
                token = featurizer.normalize_text("".join(elems[0:-dim]))
                if token in w2id:
                    emb[w2id[token]] = [float(v) for v in elems[-dim:]]
    else:
        for i, w in enumerate(vocab):
            emb[i] = hashed_vector(w, dim)
    emb[0] = 0.0
    return emb


def build_fasttext_embedding(
    model_file: Optional[str], vocab: Sequence[str], dim: int
) -> np.ndarray:
    """fastText embedding matrix (`CoQAUtils.py:52-66`); hashed fallback when
    the fasttext lib/model is unavailable."""
    emb = np.zeros((len(vocab), dim), dtype=np.float32)
    ft = None
    if model_file and os.path.isfile(model_file):
        try:
            from fasttext import load_model

            ft = load_model(model_file)
        except (ImportError, ValueError, OSError):
            log.warning("fasttext unavailable; using hashed fallback vectors")
    for i, w in enumerate(vocab):
        emb[i] = ft.get_word_vector(w) if ft is not None else hashed_vector(w, dim)
    emb[0] = 0.0
    return emb


class Preprocessor:
    """Drives the offline pipeline for all configured splits (reference
    `CoQAPreprocess.__init__:46-91`), and the in-memory featurization steps
    serving uses: annotate (:meth:`_process_data`), build the word
    vocabulary (:meth:`_build_vocab`) and assign ids + synthesize n-gram
    candidates (:meth:`_assign_ids`)."""

    def __init__(self, cfg: Config, nlp=None):
        self.cfg = cfg
        self.opt = cfg.opt
        self.feature_folder = self.opt.get("FEATURE_FOLDER", ".")
        self.n_gram = int(self.opt.get("n_gram", 2))
        self.build_test_vocab = "BuildTestVocabulary" in self.opt
        self.nlp = nlp if nlp is not None else _try_spacy()
        labels = str(self.opt.get("Task", "test")).split(",")
        if "train" in labels:
            labels.remove("train")
            labels = ["train"] + labels
        self.dataset_labels = labels
        self.train_vocab: Optional[List[str]] = None
        self.train_char_vocab: Optional[List[str]] = None
        # None = full reference schema in gram candidates; a key tuple
        # restricts the synthesized window word-dicts (serving sets this —
        # the runtime dataset reads only word/wordid/pos_id/ent_id[/charid])
        self.gram_word_keys: Optional[Tuple[str, ...]] = None

    # -- public API ------------------------------------------------------
    def ensure_preprocessed(self):
        missing = [
            l for l in self.dataset_labels if not os.path.exists(self._out_path(l))
        ]
        if not missing:
            return
        os.makedirs(self.feature_folder, exist_ok=True)
        if self.build_test_vocab:
            self.preprocess_merged()
        else:
            for label in self.dataset_labels:
                self.preprocess(label)

    def load_data(self):
        """meta msgpack -> (vocab, char_vocab, {name: np matrix}); also
        fills vocab_size/char_vocab_size into the conf
        (`CoQAPreprocess.py:481-502`)."""
        meta_path = os.path.join(self.feature_folder, "train_meta.msgpack")
        with open(meta_path, "rb") as f:
            meta = msgpack.unpack(f, raw=False, strict_map_key=False)
        emb = {}
        for key in ("glove_embedding", "fast_embedding", "phoc_embedding"):
            if key in meta:
                emb[key] = np.asarray(meta[key], dtype=np.float32)
                self.opt["vocab_size"] = emb[key].shape[0]
        self.opt["char_vocab_size"] = len(meta["char_vocab"])
        if "vocab_size" in self.opt:
            self.cfg.opt["vocab_size"] = self.opt["vocab_size"]
        return meta["vocab"], meta["char_vocab"], emb

    # -- file layout -----------------------------------------------------
    def _out_path(self, label: str) -> str:
        return os.path.join(self.feature_folder, f"{label}-preprocessed.msgpack")

    def _raw_path(self, label: str) -> str:
        return os.path.join(self.opt["datadir"], self.opt[f"{label}_FILE"])

    def _load_raw(self, label: str):
        with open(self._raw_path(label), "rb") as f:
            return msgpack.unpack(f, raw=False, strict_map_key=False)

    def preprocess_merged(self):
        """BuildTestVocabulary mode: process all splits together so every
        split shares the train vocabulary (`CoQAPreprocess.py:105-123,
        456-466`)."""
        datasets = [self._load_raw(l) for l in self.dataset_labels]
        lens = [len(d["data"]) for d in datasets]
        merged = [d for ds in datasets for d in ds["data"]]
        data = self._process_data(merged)
        self._build_and_save_meta(data)
        self._assign_ids(data)
        start = 0
        for label, n in zip(self.dataset_labels, lens):
            with open(self._out_path(label), "wb") as f:
                msgpack.pack({"data": data[start: start + n]}, f)
            start += n

    def preprocess(self, label: str):
        dataset = self._load_raw(label)
        data = self._process_data(dataset["data"])
        if label == "train":
            self._build_and_save_meta(data)
        self._assign_ids(data)
        with open(self._out_path(label), "wb") as f:
            msgpack.pack({"data": data}, f)

    def _names(self):
        ocr_names = str(
            self.opt.get("preprocess_ocr_name", "OCR")
        ).split(",")
        od_names = str(self.opt.get("preprocess_od_name", "OD")).split(",")
        gram_names = [
            t + f"_gram{self.n_gram}"
            for t in ocr_names
            if t != "distractors" and "ES_ocr" not in t
        ]
        return ocr_names, od_names, gram_names

    def _process_data(self, raw: List[dict]) -> List[dict]:
        ocr_names, od_names, _ = self._names()
        # dedupe strings across the corpus for one-shot annotation
        ocr_dict: Dict[str, int] = {}
        od_dict: Dict[str, int] = {}
        ocr_strs: List[str] = []
        od_strs: List[str] = []
        data = []
        norm_all = _normalize_boxes_corpus(raw, ocr_names)
        g = 0
        for datum in raw:
            W, H = datum["image_width"], datum["image_height"]
            out = {
                "question": datum["question"],
                "filename": datum.get("file_path", datum.get("filename", "")),
                "question_id": datum["question_id"],
                "orign_answers": datum.get("answers", []),
            }
            for name in ocr_names:
                out[name] = []
                items = datum.get(name, [])
                norm = norm_all[g]
                g += 1
                for item, npos in zip(items, norm):
                    word = item["word"].lower()
                    if word not in ocr_dict:
                        ocr_dict[word] = len(ocr_strs)
                        ocr_strs.append(word)
                    entry = {
                        "word": word,
                        "pos": npos,
                        "original": item["word"],
                        "ANLS": item.get("ANLS", 0),
                        "ACC": item.get("ACC", 0),
                    }
                    if "cnt" in item:
                        entry["cnt"] = item["cnt"]
                    if "idx" in item:
                        entry["idx"] = item["idx"]
                    out[name].append(entry)
            for name in od_names:
                out[name] = []
                for item in datum.get(name, []):
                    word = item["object"].lower()
                    if word not in od_dict:
                        od_dict[word] = len(od_strs)
                        od_strs.append(word)
                    out[name].append(
                        {
                            "object": word,
                            "pos": od_center_to_quad(item["pos"], W, H),
                            "original": item["object"],
                        }
                    )
            data.append(out)

        ocr_ann = [annotate(s, self.nlp) for s in ocr_strs]
        od_ann = [annotate(s, self.nlp) for s in od_strs]
        for out in data:
            out["annotated_question"] = annotate(out["question"], self.nlp)
            out["answers"] = [annotate(a, self.nlp) for a in out["orign_answers"]]
            for name in ocr_names:
                for item in out[name]:
                    # per-item dict copy, token lists shared read-only:
                    # ids_for adds keys into the item's own dict, nothing
                    # mutates the annotation lists in place
                    item["word"] = dict(ocr_ann[ocr_dict[item["word"]]])
            for name in od_names:
                for item in out[name]:
                    item["object"] = dict(od_ann[od_dict[item["object"]]])
        return data

    def _build_vocab(self, data: List[dict]) -> List[str]:
        """Frequency-sorted vocab: answer/question tokens first, then the
        rest, reserved ids 0..4 (`CoQAPreprocess.py:503-537`). GLOVE mode
        filters by the embedding file's vocabulary when available."""
        ocr_names, od_names, _ = self._names()
        counter_qa: Counter = Counter()
        counter_c: Counter = Counter()
        for d in data:
            counter_c.update(d["annotated_question"]["word"])
            for a in d["answers"]:
                counter_qa.update(a["word"])
            for name in ocr_names:
                for item in d[name]:
                    counter_c.update(item["word"]["word"])
            for name in od_names:
                for item in d[name]:
                    counter_c.update(item["object"]["word"])
        counter = counter_c + counter_qa

        allowed = None
        if "GLOVE" in self.opt and "FastText" not in self.opt:
            glove_file = os.path.join(
                str(self.opt.get("datadir", "")),
                str(self.opt.get("INIT_WORD_EMBEDDING_FILE", "")),
            )
            if os.path.isfile(glove_file):
                allowed = set()
                with open(glove_file, encoding="utf-8") as f:
                    for line in f:
                        allowed.add(featurizer.normalize_text(
                            "".join(line.split()[0:-300])
                        ))

        def keep(t):
            return allowed is None or t in allowed

        vocab = sorted(
            [t for t in counter_qa if keep(t)], key=counter_qa.get, reverse=True
        )
        # lexicographic pre-sort: a set's iteration order is hash-randomized
        # per process, so equal-count ties need a deterministic order
        vocab += sorted(
            sorted(t for t in counter_c.keys() - counter_qa.keys() if keep(t)),
            key=counter.get,
            reverse=True,
        )
        return RESERVED_WORDS + vocab

    def _build_char_vocab(self, vocab: Sequence[str]) -> List[str]:
        counter = Counter(c for w in vocab for c in w)
        chars = [c for c, cnt in counter.items() if cnt > 3]
        return RESERVED_CHARS + chars

    def _build_and_save_meta(self, data: List[dict]):
        self.train_vocab = self._build_vocab(data)
        self.train_char_vocab = self._build_char_vocab(self.train_vocab)
        meta: Dict[str, Any] = {
            "vocab": self.train_vocab,
            "char_vocab": self.train_char_vocab,
        }
        if "FastText" in self.opt:
            model_file = os.path.join(
                self.opt["datadir"], str(self.opt.get("fasttext_model", ""))
            )
            meta["fast_embedding"] = build_fasttext_embedding(
                model_file, self.train_vocab, int(self.opt.get("fast_dim", 300))
            ).tolist()
        if "GLOVE" in self.opt:
            glove_file = os.path.join(
                self.opt["datadir"],
                str(self.opt.get("INIT_WORD_EMBEDDING_FILE", "")),
            )
            meta["glove_embedding"] = build_glove_embedding(
                glove_file, self.train_vocab, int(self.opt.get("glove_dim", 300))
            ).tolist()
        if "PHOC" in self.opt:
            meta["phoc_embedding"] = build_phoc_embedding(self.train_vocab).tolist()
        path = os.path.join(self.feature_folder, "train_meta.msgpack")
        with open(path, "wb") as f:
            msgpack.pack(meta, f)

    def _assign_ids(self, data: List[dict]):
        """wordid assignment + n-gram candidate synthesis
        (`CoQAPreprocess.py:355-416`)."""
        if self.train_vocab is None:
            raise ValueError("train_vocab must be set before ids are assigned")
        w2id = {w: i for i, w in enumerate(self.train_vocab)}
        c2id = (
            {c: i for i, c in enumerate(self.train_char_vocab)}
            if self.train_char_vocab
            else None
        )
        # item word-dicts are per-item COPIES whose token lists are shared
        # by identity with the deduped annotations (_process_data), so ids
        # are memoized per unique token list WITHIN this call (the memo
        # holds the list itself, keeping id() valid). The produced id lists
        # are shared by reference too: nothing downstream mutates them.
        memo: Dict[int, tuple] = {}

        def ids_for(ann):
            words = ann["word"]
            hit = memo.get(id(words))
            if hit is not None and hit[0] is words:
                ann["wordid"] = hit[1]
                if c2id is not None:
                    ann["charid"] = hit[2]
                return
            wordid = token2id_sent(words, w2id)
            charid = char2id_sent(words, c2id) if c2id is not None else None
            ann["wordid"] = wordid
            if charid is not None:
                ann["charid"] = charid
            memo[id(words)] = (words, wordid, charid)

        ocr_names, od_names, gram_names = self._names()
        for d in data:
            ids_for(d["annotated_question"])
            d["raw_question_offsets"] = get_raw_context_offsets(
                d["annotated_question"]["word"], d["question"].lower()
            )
            for name in ocr_names:
                for item in d[name]:
                    ids_for(item["word"])
            for name in od_names:
                for item in d[name]:
                    ids_for(item["object"])
            answers = d["orign_answers"]
            for gram_name in gram_names:
                src_name = gram_name[: -len(f"_gram{self.n_gram}")]
                src = d[src_name]
                n = self.n_gram
                cands = []
                gram_keys = self.gram_word_keys
                if n == 2 and len(src) >= 2:
                    # the shipped n_gram, specialized: same outputs as the
                    # general window loop below. All word dicts in a source
                    # share one schema, so the key set is computed once.
                    keys = (
                        tuple(k for k in src[0]["word"] if k in gram_keys)
                        if gram_keys is not None
                        else tuple(src[0]["word"])
                    )
                    for i in range(len(src) - 1):
                        a, b = src[i], src[i + 1]
                        pa, pb = a["pos"], b["pos"]
                        # bounding merge, reference index quirk: min on
                        # 0,1,3,4 / max on 2,5,6,7 (merge_quads semantics)
                        pos = [
                            pa[0] if pa[0] < pb[0] else pb[0],
                            pa[1] if pa[1] < pb[1] else pb[1],
                            pa[2] if pa[2] > pb[2] else pb[2],
                            pa[3] if pa[3] < pb[3] else pb[3],
                            pa[4] if pa[4] < pb[4] else pb[4],
                            pa[5] if pa[5] > pb[5] else pb[5],
                            pa[6] if pa[6] > pb[6] else pb[6],
                            pa[7] if pa[7] > pb[7] else pb[7],
                        ]
                        w0, w1 = a["word"], b["word"]
                        cands.append({
                            "word": {k: w0[k] + w1[k] for k in keys},
                            "pos": pos,
                            "original": (
                                a["original"] + " " + b["original"]
                            ).lower(),
                        })
                elif n != 2:
                    for i in range(len(src)):
                        if i + n > len(src):
                            break
                        text = " ".join(
                            t["original"] for t in src[i : i + n]
                        ).lower()
                        words = [src[j]["word"] for j in range(i, i + n)]
                        pos = list(src[i]["pos"])
                        for j in range(i + 1, i + n):
                            pos = merge_quads(pos, src[j]["pos"])
                        word: Dict[str, list] = {}
                        for k, v in words[0].items():
                            if gram_keys is not None and k not in gram_keys:
                                continue
                            if n == 1:
                                word[k] = list(v)
                            else:
                                acc = v
                                for w in words[1:]:
                                    acc = acc + w[k]
                                word[k] = acc
                        cands.append(
                            {"word": word, "pos": pos, "original": text}
                        )
                texts = [c["original"] for c in cands]
                if answers and texts:
                    anls = metrics.anls_batch(answers, texts)
                    acc = metrics.acc_batch(answers, texts)
                else:
                    anls = np.zeros(len(texts))
                    acc = np.zeros(len(texts))
                for c, a, ac in zip(cands, anls, acc):
                    c["ANLS"] = float(a)
                    c["ACC"] = float(ac)
                d[gram_name] = cands
            # per-candidate scores for the base OCR sources too
            if answers:
                for name in ocr_names:
                    items = d[name]
                    if not items:
                        continue
                    texts = [t["original"].lower() for t in items]
                    anls = metrics.anls_batch(answers, texts)
                    acc = metrics.acc_batch(answers, texts)
                    for t, a, ac in zip(items, anls, acc):
                        t["ANLS"] = float(a)
                        t["ACC"] = float(ac)
