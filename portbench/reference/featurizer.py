"""Linguistic feature id spaces and a spaCy-free tokenizer/tagger.

The reference derives its POS/ENT embedding id spaces from a live spaCy
2.x ``en_core_web_sm`` model (`Utils/CoQAUtils.py:31-32`):

* ``POS = {'' : 0} + nlp.tagger.labels``  (PTB tagset, 50 tags)
* ``ENT = {'' : 0} + nlp.entity.move_names`` (BILUO moves over 18 OntoNotes
  entity types, plus the 'M' and 'O' moves)

Pinning a live model into the id space is fragile; we freeze the exact
canonical tables here so the id space is reproducible without spaCy
installed. When consuming already-preprocessed msgpack artifacts the ids are
baked in and these tables are only used for embedding sizes.

For offline preprocessing without spaCy, :func:`tokenize_tag` provides a
rule-based tokenizer + heuristic tagger covering the reference pipeline's
needs (`Utils/GeneralUtils.py:94-108`, `Utils/CoQAPreprocess.py:569-599`):
the model never sees tags semantically, only as learned embedding ids, so a
consistent heuristic tagger preserves trainability. The port always uses
this tagger (never spaCy), so its tags match a spaCy-free run of the JAX
package.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Tuple

# PTB tagset as enumerated by spaCy 2.x en_core_web_sm's tagger labels.
PTB_TAGS = [
    "$", "''", ",", "-LRB-", "-RRB-", ".", ":", "ADD", "AFX", "CC",
    "CD", "DT", "EX", "FW", "HYPH", "IN", "JJ", "JJR", "JJS", "LS",
    "MD", "NFP", "NN", "NNP", "NNPS", "NNS", "PDT", "POS", "PRP",
    "PRP$", "RB", "RBR", "RBS", "RP", "SYM", "TO", "UH", "VB", "VBD",
    "VBG", "VBN", "VBP", "VBZ", "WDT", "WP", "WP$", "WRB", "XX",
    "_SP", "``",
]

# OntoNotes 5 entity types used by en_core_web_sm.
ENTITY_TYPES = [
    "CARDINAL", "DATE", "EVENT", "FAC", "GPE", "LANGUAGE", "LAW",
    "LOC", "MONEY", "NORP", "ORDINAL", "ORG", "PERCENT", "PERSON",
    "PRODUCT", "QUANTITY", "TIME", "WORK_OF_ART",
]

# BILUO transition-move names in spaCy enumeration order: the 'M' (missing)
# move, then per-type B/I/L/U blocks, then 'O'.
ENT_MOVES: List[str] = ["M"]
for _move in ("B", "I", "L", "U"):
    ENT_MOVES.extend(f"{_move}-{_t}" for _t in ENTITY_TYPES)
ENT_MOVES.append("O")

POS = {w: i for i, w in enumerate([""] + PTB_TAGS)}
ENT = {w: i for i, w in enumerate([""] + ENT_MOVES)}

POS_VOCAB_SIZE = len(POS)   # 51
ENT_VOCAB_SIZE = len(ENT)   # 75


def pos_id(tag: str) -> int:
    """Map a PTB tag to its embedding id; unknown -> 0 (reference
    `CoQAPreprocess.process` uses token2id(..., default 0))."""
    return POS.get(tag, 0)


def ent_id(iob: str, ent_type: str) -> int:
    """Map an (IOB, type) pair to an id the way `CoQAPreprocess.process`
    does: 'O' if outside else '<IOB>-<TYPE>' looked up in ENT, default 0.

    Note spaCy's ``token.ent_iob_`` yields IOB ('B'/'I'/'O'), so 'L-'/'U-'
    moves never occur at preprocessing time even though they occupy id
    space — faithfully reproduced here.
    """
    name = "O" if iob == "O" else f"{iob}-{ent_type}"
    return ENT.get(name, 0)


# ---------------------------------------------------------------------------
# Rule-based tokenizer (spaCy-free path)
# ---------------------------------------------------------------------------

_SPACE_EXTEND = re.compile(
    "-|‐|‑|‒|–|—|―|%|\\[|\\]|:|\\(|\\)|/|\t"
)


def normalize_text(text: str) -> str:
    """NFD normalization (`Utils/GeneralUtils.py:27`)."""
    return unicodedata.normalize("NFD", text)


def pre_proc(text: str) -> str:
    """Punctuation spacing exactly as `Utils/GeneralUtils.py:34-38`."""
    text = _SPACE_EXTEND.sub(lambda m: " " + m.group(0) + " ", text)
    text = text.strip(" \n")
    text = re.sub(r"\s+", " ", text)
    return text


_TOKEN_RE = re.compile(
    # ordinal | number with separators | word (incl. apostrophes) | single other
    r"\d+(?:st|nd|rd|th)|\d+(?:[.,]\d+)*|[a-z]+(?:'[a-z]+)?|\S",
)

_PUNCT_RE = re.compile(r"^\W+$", re.UNICODE)

_NUM_RE = re.compile(r"^\d+(?:[.,]\d+)*$")
_ORDINAL_RE = re.compile(r"^\d+(?:st|nd|rd|th)$")

_DET = {"a", "an", "the", "this", "that", "these", "those"}
_PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
         "us", "them", "what", "who", "whom"}
_PREP = {"of", "in", "on", "at", "by", "for", "with", "about", "against",
         "between", "into", "through", "during", "before", "after", "above",
         "below", "to", "from", "up", "down", "under", "over"}
_CONJ = {"and", "or", "but", "nor", "so", "yet"}
_WH = {"what", "which", "whose"}
_MONTHS = {"january", "february", "march", "april", "may", "june", "july",
           "august", "september", "october", "november", "december"}


def _tag_token(tok: str) -> Tuple[str, str, str]:
    """Heuristic (pos_tag, ent_iob, ent_type) for one lowercase token."""
    if _NUM_RE.match(tok):
        return "CD", "B", "CARDINAL"
    if _ORDINAL_RE.match(tok):
        return "CD", "B", "ORDINAL"
    if tok in _MONTHS:
        return "NNP", "B", "DATE"
    if tok in _DET:
        return "DT", "O", ""
    if tok in _WH:
        return "WDT", "O", ""
    if tok in _PRON:
        return "PRP", "O", ""
    if tok in _PREP:
        return "IN", "O", ""
    if tok in _CONJ:
        return "CC", "O", ""
    if _PUNCT_RE.match(tok):
        return "NFP", "O", ""
    if tok.endswith("ing"):
        return "VBG", "O", ""
    if tok.endswith("ed"):
        return "VBD", "O", ""
    if tok.endswith("ly"):
        return "RB", "O", ""
    if tok.endswith("s") and len(tok) > 3:
        return "NNS", "O", ""
    return "NN", "O", ""


def tokenize_tag(sentence: str):
    """Lowercase, pre_proc, tokenize, and tag a sentence.

    Returns (tokens, pos_ids, ent_ids) matching the reference's
    ``spacyTokenize``-era contract: punctuation/space tokens are KEPT (the
    reference's `CoQAPreprocess.process` keeps all spaCy tokens), NFD
    normalized.
    """
    sentence = sentence.lower()
    sentence = pre_proc(sentence)
    tokens = _TOKEN_RE.findall(sentence)
    words, pids, eids = [], [], []
    for tok in tokens:
        tag, iob, etype = _tag_token(tok)
        words.append(normalize_text(tok))
        pids.append(pos_id(tag))
        eids.append(ent_id(iob, etype))
    return words, pids, eids
