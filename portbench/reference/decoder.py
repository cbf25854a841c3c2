"""Answer decoding: score vector -> answer string.

Byte-faithful port of the selection logic in `SDNetTrainer.predict:378-451`
(the parity-gated path): descending score scan with the no-answer break,
the <OCR>-sentinel skip, and the fixed/yesno/candidate index mapping. Runs
on host over the small [B, C] score matrix. Copy of
``ruart_tpu/eval/decoder.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from portbench.reference.constants import (
    ANSWER_NO,
    ANSWER_NOREAD,
    ANSWER_UNANSWERABLE,
    ANSWER_YES,
)
from portbench.reference import metrics


def decode_answer(
    prob: np.ndarray,
    ocr_list: Sequence[str],
    num_cnt: int,
    fixed_answers: Optional[Sequence[str]] = None,
    yesno: bool = False,
    label_no_answer: bool = False,
) -> Dict[str, Any]:
    """Decode one question's score vector.

    prob: [C] scores; ocr_list: candidate strings (sentinel last);
    num_cnt: real candidate count (incl. sentinel).
    """
    fixed_len = len(fixed_answers) if fixed_answers else 0
    yesno_num = 3 if yesno else 0
    bound = fixed_len + yesno_num + num_cnt
    # fast path: argmax (== first element of the stable descending sort)
    # is accepted outright unless it is the sentinel / out of bound
    idx = int(prob.argmax())
    accepted = (label_no_answer and idx == prob.shape[0] - 1) or (
        idx != bound - 1 and idx < bound
    )
    if not accepted:
        ids = np.argsort(-prob, kind="stable")
        for idx_ in ids:
            idx = int(idx_)
            if label_no_answer and idx == prob.shape[0] - 1:
                break
            # Skip the <OCR> sentinel candidate. The reference compares the
            # raw score index against len(ocr_list)-1
            # (`SDNetTrainer.py:409-410`), which is only correct when
            # fixed_len == yesno_num == 0 (true for the shipped conf, so
            # this is bit-identical on the parity path); with extra heads
            # the offset-correct form below is used.
            if idx == bound - 1:
                continue
            if idx < bound:
                break

    if idx < fixed_len:
        answer = fixed_answers[idx]
    elif idx < fixed_len + yesno_num:
        if idx < fixed_len + 1:
            answer = ANSWER_NOREAD
        elif idx < fixed_len + 2:
            answer = ANSWER_YES
        else:
            answer = ANSWER_NO
    elif idx < fixed_len + yesno_num + num_cnt:
        answer = ocr_list[idx - fixed_len - yesno_num]
    else:
        answer = ANSWER_UNANSWERABLE
    return {"answer": answer, "idx": idx, "score": float(prob[idx])}


def decode_batch(
    probs: np.ndarray,
    extra_info: Sequence[Dict[str, Any]],
    num_cnt: np.ndarray,
    fixed_answers: Optional[Sequence[str]] = None,
    yesno: bool = False,
    label_no_answer: bool = False,
):
    """Decode a batch and score it (`SDNetTrainer.py:392-451`).

    Returns (res, save_res, anls_sum, acc_sum): res entries are submission
    rows {question_id, answer}; ANLS uses the >=0.5 zeroing and ACC the
    x10/3 cap exactly as the trainer applies them."""
    res: List[dict] = []
    save_res: List[dict] = []
    anls_sum = acc_sum = 0.0
    B = probs.shape[0]
    for i in range(B):
        info = extra_info[i]
        out = decode_answer(
            probs[i], info["ocr_list"], int(num_cnt[i]),
            fixed_answers, yesno, label_no_answer,
        )
        answer = out["answer"]
        res.append({"question_id": info["q_id"], "answer": answer})
        save_res.append(
            {
                "question_id": info["q_id"],
                "prediction": answer,
                "answers": info.get("answers"),
                "score": out["score"],
                "idx": out["idx"],
                "ids_len": int(probs.shape[1]),
                "ocr_list": list(info["ocr_list"]),
            }
        )
        answers = info.get("answers")
        if answers:
            _anls = metrics.note_stvqa(answers, answer)
            _acc = metrics.note_textvqa(answers, answer)
            acc_sum += metrics.final_acc(_acc, len(answers))
            anls_sum += _anls if _anls >= 0.5 else 0.0
    return res, save_res, anls_sum, acc_sum
