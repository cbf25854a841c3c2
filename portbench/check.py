"""The comparison that decides ``correct``: what the window produced,
against the plain reference (``portbench.reference``, a frozen copy of the
port's model and data path with plain attention, TF32 off).

The reference takes from the run only what the benchmark made and handed
to both sides: the raw items drawn from the seed, the seed of the weights,
and which items went into which batch or wave. It featurizes, collates,
builds the model and its weights, and runs, on its own. It reads the
program's outputs only to judge them.

Training (:func:`train_numbers`): the first three steps of the train step
that the window then goes on driving, as replays of its graphs (the
driver adds ``checked_captures``, the captures among them, limit 0). ``loss``: the largest gap between
the program's loss and the reference's over the three steps, over the
reference's. ``grad``: the gradient as the optimizer got it at step 1
(Adamax: its first moment after one step over 1 - b1), per leaf, the gap
of the norms over the larger of the reference leaf's norm and the median
leaf's, worst leaf. ``change``: the same for each leaf's change over the
three steps, read before step 4; leaves whose reference gradient is under
a thousandth of the median leaf's are left out (round-off alone moves them
under Adamax).

Answers (:func:`answer_numbers`): a sample of the answers due in the
window, drawn from the seed. ``choice``: the widest gap by which the
reference's probability of the program's answer (its text, on the
reference's own candidates; an answer that is no candidate's gets 0) lies
below the reference's best; ``score``: the largest gap between the
program's probability for the candidate it chose and the reference's.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import build

@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 for matmuls and cuDNN on or off inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Reference:
    """The reference for one configuration: conf, vocabulary, items,
    model with the seed's weights."""

    def __init__(self, config: Dict[str, Any], extra: Dict[str, Any],
                 device, seed: int):
        from portbench.reference.bert_config import BertConfig
        from portbench.reference.config import Config, read_conf_lines

        # full fp32 whatever the process set before (cuDNN's LSTMs would
        # take TF32 by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = Config(read_conf_lines(build.conf_lines(config, extra)))
        self.bert = BertConfig(**config["bert"], attention_impl="plain")
        self.device = torch.device(device)
        self.seed = seed
        self.model = None

    def featurize(self, raw: Sequence[dict], vocab_from: Sequence[dict],
                  mode: str):
        """The dataset of ``raw``, with the vocabulary built from
        ``vocab_from`` (``BuildTestVocabulary``: the whole corpus)."""
        from portbench.reference.dataset import VQADataset
        from portbench.reference.preprocess import Preprocessor
        from portbench.reference.wordpiece import (
            WordPieceTokenizer, build_demo_vocab)

        pre = self.pre = Preprocessor(self.cfg)
        pre.train_vocab = pre._build_vocab(pre._process_data(list(vocab_from)))
        pre.train_char_vocab = pre._build_char_vocab(pre.train_vocab)
        data = pre._process_data(list(raw))
        pre._assign_ids(data)
        self.cfg.opt["vocab_size"] = len(pre.train_vocab)
        self.tokenizer = WordPieceTokenizer(build_demo_vocab())
        return VQADataset(data, self.cfg, mode=mode, tokenizer=self.tokenizer)

    def build_model(self):
        import dataclasses

        from portbench.reference.collate import Collator
        from portbench.reference.model import RUArtModel
        from portbench.reference.spec import ModelSpec

        bert = self.bert
        if bert.vocab_size < len(self.tokenizer.vocab):
            bert = dataclasses.replace(bert, vocab_size=len(self.tokenizer.vocab))
        self.spec = ModelSpec.from_config(self.cfg, bert)
        with self.device:
            model = RUArtModel(self.spec)
        build.make_weights(model, self.seed)
        self.model = model
        self.collator = Collator(self.cfg)
        return model

    def collate(self, items: List[dict]):
        return self.collator(items)

    def to_device(self, block: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                for k, v in block.items()}

    @torch.no_grad()
    def scores(self, batch) -> np.ndarray:
        self.model.eval()
        q, ocr, od = (self.to_device(b) for b in batch[:3])
        return self.model(q, ocr, od).float().cpu().numpy()


# -- training ---------------------------------------------------------------


def reference_steps(ref: Reference, batches, half_batch: bool = False
                    ) -> Dict[str, Any]:
    """Three train steps of the reference on ``batches`` (collated numpy):
    losses, per-leaf gradient norms at step 1 (as the optimizer gets
    them), per-leaf change norms after the last step."""
    from portbench.reference.loss import make_loss_fn
    from portbench.reference.optim import Optimizer, make_row_pinner

    model, cfg = ref.model, ref.cfg
    tune = "TUNE_PARTIAL" in cfg.opt
    opt = Optimizer(str(cfg.opt.get("optimizer", "#")),
                    float(cfg.opt["lr"]) if "lr" in cfg.opt else None,
                    float(cfg.opt.get("grad_clipping", 10)), model, ref.spec,
                    tune)
    pin = make_row_pinner(model, ref.spec,
                          int(cfg.opt["tune_partial"]) if tune else None)
    loss_fn = make_loss_fn(str(cfg.opt.get("loss", "BCE_D1")))
    model.seed_dropout(cfg.seed)
    start = {n: p.detach().clone() for n, p in opt.params.items()}
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        q, ocr, od = (ref.to_device(b) for b in batch[:3])
        gt = torch.as_tensor(batch[3]).to(ref.device)
        model.train()
        opt.zero_grad()
        scores = model(q, ocr, od)
        if half_batch:
            h = scores.shape[0] // 2
            loss = loss_fn(scores[:h], gt[:h])
        else:
            loss = loss_fn(scores, gt)
        loss.backward()
        if i == 0:
            clipped = opt._clipped_grads()
            grads = {n: float(g.double().norm())
                     for n, g in zip(opt.params, clipped)}
        opt.step()
        pin()
        losses.append(float(loss.detach()))
    change = {n: float((p.detach() - start[n]).double().norm())
              for n, p in opt.params.items()}
    return {"loss": losses, "grad": grads, "change": change}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Sequence[str]] = None):
    """(the worst leaf's gap of norms over the larger of its reference
    norm and the median leaf's, that leaf's name)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return float("nan"), None
    floor = statistics.median(ref[n] for n in names)
    worst, where = 0.0, None
    for n in names:
        if n not in prog:
            return float("inf"), n
        denom = max(ref[n], floor)
        gap = abs(prog[n] - ref[n]) / denom if denom > 0 else (
            0.0 if prog[n] == 0 else float("inf"))
        if gap >= worst:
            worst, where = gap, n
    return worst, where


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any]):
    """({loss, grad, change} (see the module doc) of ``prog`` against
    ``ref``, both as :func:`reference_steps` returns them; the worst
    leaf of each of the last two)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    floor = statistics.median(ref["grad"].values())
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * floor]
    grad, grad_leaf = leaf_gap(prog["grad"], ref["grad"])
    change, change_leaf = leaf_gap(prog["change"], ref["change"], moved)
    return ({"loss": loss, "grad": grad, "change": change},
            {"grad": grad_leaf, "change": change_leaf,
             "left_out": sorted(set(ref["grad"]) - set(moved))})


# -- answers ----------------------------------------------------------------


def answer_numbers(ref: Reference, batches, answers) -> Dict[str, float]:
    """``batches``: collated reference batches; ``answers``: per batch, a
    list of (row, answer, idx, score) of the program for the rows to
    judge (``answer`` None: the program gave none)."""
    from portbench.reference.decoder import decode_answer

    spec = ref.spec
    choice = score = 0.0
    for batch, rows in zip(batches, answers):
        probs = ref.scores(batch)
        num, extra = batch[1]["num"], batch[4]
        for row, answer, idx, prog_score in rows:
            p = probs[row]
            args = (extra[row]["ocr_list"], int(num[row]), None,
                    spec.label_yesno, spec.label_no_answer)
            best = decode_answer(p, *args)
            # the reference's probability of the program's answer: the
            # best of the candidates whose text it is (none: 0)
            texts = [decode_answer(_onehot(p, j), *args)["answer"]
                     for j in range(p.shape[0])]
            mine = [float(p[j]) for j, a in enumerate(texts) if a == answer]
            choice = max(choice, best["score"] - max(mine, default=0.0))
            if 0 <= idx < p.shape[0]:
                score = max(score, abs(float(prog_score) - float(p[idx])))
            else:
                score = max(score, 1.0)
    return {"choice": choice, "score": score}


def _onehot(p: np.ndarray, j: int) -> np.ndarray:
    out = np.zeros_like(p)
    out[j] = 1.0
    return out


def limited(numbers: Dict[str, float], limits: Dict[str, Any],
            prefix: str) -> Dict[str, tuple]:
    """{prefix.name: (value, limit)}; a number without a limit gets 0."""
    out = {}
    for k, v in numbers.items():
        name = f"{prefix}.{k}"
        out[name] = (float(v), float(limits.get(name, 0.0)))
    return out
