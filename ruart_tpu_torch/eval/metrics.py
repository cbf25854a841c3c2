"""Answer-quality metrics: ANLS (ST-VQA) and soft accuracy (TextVQA).

Semantics follow the reference exactly:

* ``anls_score(a, b)`` = 1 - levenshtein(a, b) / max(len(a), len(b)),
  computed on lowercased strings, with the empty-vs-empty case scoring 1
  (`Utils/eval_func.py:1-28`).
* ``note_stvqa(gts, pred)`` = max over ground truths (`eval_func.py:29-35`);
  the >= 0.5 zeroing threshold is applied by the caller
  (`Models/SDNetTrainer.py:448`).
* ``note_textvqa(gts, pred)`` = exact-match-count / 10 (`eval_func.py:62-68`);
  the ``min(x*10/3, 1)`` cap is applied by the caller
  (`SDNetTrainer.py:444-447`).

For the preprocessing hot path (per-candidate ANLS/ACC over every n-gram
OCR candidate, `Utils/CoQAPreprocess.py:381-416`), ``levenshtein_batch``
vectorizes the DP over the candidate axis with numpy so one ground truth is
scored against thousands of candidates at once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """Plain single-pair edit distance (insert/delete/substitute, unit cost)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def levenshtein_batch(query: str, candidates: Sequence[str]) -> np.ndarray:
    """Edit distance of ``query`` vs many candidates, vectorized over the
    candidate axis.

    Runs the standard DP row-by-row over the query, with each DP row held as
    a [n_cand, max_len+1] matrix; the inner scan over candidate positions is
    a cumulative-min recurrence evaluated per-column (numpy), which is
    O(len(query) * max_len) vector ops instead of a Python triple loop.
    """
    n = len(candidates)
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    lens = np.array([len(c) for c in candidates], dtype=np.int32)
    max_len = int(lens.max(initial=0))
    if max_len == 0:
        return np.full((n,), len(query), dtype=np.int32)
    # char matrix, padded with -1 (never matches)
    chars = np.full((n, max_len), -1, dtype=np.int32)
    for i, c in enumerate(candidates):
        if c:
            chars[i, : len(c)] = np.frombuffer(c.encode("utf-32-le"), dtype=np.uint32)[
                : len(c)
            ].astype(np.int32)
    q = np.frombuffer(query.encode("utf-32-le"), dtype=np.uint32).astype(np.int32)

    prev = np.broadcast_to(np.arange(max_len + 1, dtype=np.int32), (n, max_len + 1)).copy()
    for i, qc in enumerate(q, start=1):
        sub = prev[:, :-1] + (chars != qc)          # substitution / match
        dele = prev[:, 1:] + 1                      # deletion (advance in query)
        best = np.minimum(sub, dele)
        cur = np.empty_like(prev)
        cur[:, 0] = i
        # insertion is a prefix-min recurrence: cur[j] = min(best[j-1], cur[j-1]+1)
        running = cur[:, 0]
        for j in range(1, max_len + 1):
            running = np.minimum(best[:, j - 1], running + 1)
            cur[:, j] = running
        prev = cur
    return prev[np.arange(n), lens]


def anls_score(str1: str, str2: str) -> float:
    """Normalized Levenshtein similarity of one pair (`eval_func.py:1-28`)."""
    str1 = str1.lower()
    str2 = str2.lower()
    denom = max(len(str1), len(str2))
    if denom == 0:
        return 1.0
    return 1.0 - levenshtein(str1, str2) / denom


def note_stvqa(gt_list: Sequence[str], word: str) -> float:
    """Best ANLS of ``word`` against the ground-truth list (`eval_func.py:29-35`)."""
    s = -1.0
    for gt in gt_list:
        s = max(s, anls_score(gt, word))
    return s


def note_textvqa(gt_list: Sequence[str], word: str) -> float:
    """TextVQA soft-accuracy numerator: match-count / 10 (`eval_func.py:62-68`)."""
    cnt = sum(1 for gt in gt_list if gt.lower() == word)
    return cnt / 10.0


def anls_batch(gt_list: Sequence[str], candidates: Sequence[str]) -> np.ndarray:
    """note_stvqa for every candidate at once (vectorized).

    Candidates are lowercased like `eval_func.stvqa_score`; returns
    [n_cand] float32 of max-over-gt ANLS.
    """
    cands = [c.lower() for c in candidates]
    n = len(cands)
    best = np.full((n,), -1.0, dtype=np.float32)
    cand_lens = np.array([len(c) for c in cands], dtype=np.float32)
    for gt in gt_list:
        gt = gt.lower()
        ld = levenshtein_batch(gt, cands).astype(np.float32)
        denom = np.maximum(np.maximum(cand_lens, float(len(gt))), 1.0)
        score = 1.0 - ld / denom
        if len(gt) == 0:
            score = np.where(cand_lens == 0, 1.0, score)
        best = np.maximum(best, score)
    return best


def acc_batch(gt_list: Sequence[str], candidates: Sequence[str]) -> np.ndarray:
    """note_textvqa for every candidate at once."""
    gts = [g.lower() for g in gt_list]
    return np.array(
        [sum(1 for g in gts if g == c.lower()) / 10.0 for c in candidates],
        dtype=np.float32,
    )


def stvqa_label(
    gt_list: Sequence[str], ocr_words: Sequence[str]
) -> Optional[Tuple[int, float]]:
    """Best (candidate index, ANLS) over ground truths (`eval_func.py:37-60`).

    Returns None when every ground truth is empty (reference returns False).
    """
    label_score, label_idx = -1.0, -1
    all_none = True
    for gt in gt_list:
        if len(gt) == 0:
            continue
        all_none = False
        ls, li = -1.0, -1
        for idx, ocr in enumerate(ocr_words):
            s = anls_score(gt, ocr)
            if s > ls:
                ls, li = s, idx
        if ls > label_score:
            label_score, label_idx = ls, li
    if all_none:
        return None
    return label_idx, label_score


def textvqa_label(
    gt_list: Sequence[str], ocr_words: Sequence[str]
) -> Tuple[int, float]:
    """Best (candidate index, match-count/10) (`eval_func.py:72-88`)."""
    gts = [g.lower() for g in gt_list]
    label_score, label_idx = -1.0, -1
    for idx, ocr in enumerate(ocr_words):
        s = sum(1 for g in gts if g == ocr) / 10.0
        if s > label_score:
            label_score, label_idx = s, idx
    return label_idx, label_score


def final_anls(anls: float) -> float:
    """Apply the official >=0.5 zeroing rule (`SDNetTrainer.py:448`)."""
    return anls if anls >= 0.5 else 0.0


def final_acc(acc: float, n_answers: int) -> float:
    """Apply the ACC cap rule (`SDNetTrainer.py:444-447`)."""
    if n_answers == 10:
        return min(acc * 10.0 / 3.0, 1.0)
    return min(acc * 10.0, 1.0)
