"""CoQA-style span-QA scoring utilities — copy of ``ruart_tpu/eval/coqa.py``.

The reference carries SDNet's CoQA scorers in its utils
(`Utils/CoQAUtils.py:634-859`: normalize/F1/EM, per-question max-over-GT,
ensemble voting). They are not used by the VQA path but are part of the
library surface; reimplemented here without pandas/torch.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, List, Sequence


def normalize_answer(s: str) -> str:
    """Lower, strip punctuation/articles/extra whitespace
    (`CoQAUtils.py:693-709`)."""

    def remove_articles(text):
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text):
        return " ".join(text.split())

    def remove_punc(text):
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def _pair_f1(pred_tokens: List[str], gt_tokens: List[str]) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def f1_score(pred: str, answers: Sequence[str]) -> float:
    """Token-level F1 (`CoQAUtils._f1_score:653-681`).

    With a single ground truth this is plain F1.  With multiple ground
    truths the reference does NOT take the max: it averages, over each
    held-out answer i, the max F1 against the remaining answers
    (leave-one-out, `CoQAUtils.py:672-680`) — a human-agreement-style
    normalization so one odd annotator answer cannot grant full credit.
    """
    if pred is None or answers is None:
        return 0.0
    if len(answers) == 0:
        return 1.0 if len(pred) == 0 else 0.0
    pred_tokens = normalize_answer(pred).split()
    scores = [
        _pair_f1(pred_tokens, normalize_answer(gt).split()) for gt in answers
    ]
    if len(scores) == 1:
        return scores[0]
    total = 0.0
    for i in range(len(scores)):
        total += max(scores[:i] + scores[i + 1 :])
    return total / len(scores)


def exact_match(pred: str, answers: Sequence[str]) -> float:
    return float(
        any(normalize_answer(pred) == normalize_answer(a) for a in answers)
    )


def score_predictions(
    predictions: Dict[str, str], ground_truths: Dict[str, List[str]]
) -> Dict[str, float]:
    """Corpus EM/F1 over {qid: pred} vs {qid: [answers]}
    (`CoQAUtils.py:754-835` without the domain split table)."""
    em_sum = f1_sum = 0.0
    n = 0
    for qid, answers in ground_truths.items():
        pred = predictions.get(qid, "")
        em_sum += exact_match(pred, answers)
        f1_sum += f1_score(pred, answers)
        n += 1
    n = max(n, 1)
    return {"em": em_sum / n * 100.0, "f1": f1_sum / n * 100.0, "n": n}


def ensemble_predict(
    pred_list: Sequence[Sequence[str]],
    score_list: Sequence[Sequence[float]],
    vote_by_cnt: bool = False,
):
    """Per-example ensemble vote over models (`CoQAUtils.py:638-651`).

    ``pred_list[m][e]`` / ``score_list[m][e]`` are model m's answer and
    confidence for example e.  Each example's answer is the phrase with
    the highest summed score (or count if ``vote_by_cnt``), ties broken
    by earliest model index (the reference's ``firstappear = -index``).
    Returns (predictions, best_scores), one per example.
    """
    predictions: List[str] = []
    best_scores: List[float] = []
    for phrases, scores in zip(zip(*pred_list), zip(*score_list)):
        totals: Dict[str, float] = {}
        first: Dict[str, int] = {}
        for index, (phrase, s) in enumerate(zip(phrases, scores)):
            totals[phrase] = totals.get(phrase, 0.0) + (
                1.0 if vote_by_cnt else s
            )
            if phrase not in first:
                first[phrase] = -index
        winner = max(totals.items(), key=lambda kv: (kv[1], first[kv[0]]))
        predictions.append(winner[0])
        best_scores.append(winner[1])
    return predictions, best_scores


def gen_upper_triangle_mask(context_len: int, max_len: int):
    """Span-score mask: valid (start, end) pairs with end >= start and
    span <= max_len (`CoQAUtils.gen_upper_triangle:163-175` as a boolean
    mask; callers add it to start+end score grids)."""
    import numpy as np

    i = np.arange(context_len)[:, None]
    j = np.arange(context_len)[None, :]
    return (j >= i) & (j - i <= max_len - 1)


def find_span(offsets, start: int, end: int):
    """Map char (start, end) to token index span
    (`CoQAPreprocess.find_span:660-668`)."""
    start_index = end_index = -1
    for i, off in enumerate(offsets):
        if start_index < 0 or start >= off[0]:
            start_index = i
        if end_index < 0 and end <= off[1]:
            end_index = i
    return start_index, end_index


def find_span_with_gt(context: str, offsets, ground_truth: str):
    """Best-F1 token span for a ground-truth string
    (`CoQAPreprocess.find_span_with_gt:640-658`)."""
    best_f1 = 0.0
    best_span = (len(offsets) - 1, len(offsets) - 1)
    gt = normalize_answer(ground_truth).split()
    candidates = [
        i for i in range(len(offsets))
        if context[offsets[i][0] : offsets[i][1]].lower() in gt
    ]
    for a in range(len(candidates)):
        for b in range(a, len(candidates)):
            i, j = candidates[a], candidates[b]
            pred = normalize_answer(context[offsets[i][0] : offsets[j][1]]).split()
            common = Counter(pred) & Counter(gt)
            num_same = sum(common.values())
            if num_same > 0:
                precision = num_same / len(pred)
                recall = num_same / len(gt)
                f1 = 2 * precision * recall / (precision + recall)
                if f1 > best_f1:
                    best_f1 = f1
                    best_span = (i, j)
    return best_span
