"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run at a tiny size on the CPU (the look for a
card skipped, the cell's own limits), first sound, then with one fault
the cell can have planted in the port: a train step that returns its
state unchanged; half of each batch left out of the loss, the mean taken
over the rest; an answer altered where it is produced. (One chip: no cell
exchanges anything between chips.)"""

import pytest

from portbench import harness
from portbench.tests import tiny

TRAIN = ("stvqa-fp32.train-b16", "stvqa-fp32", "train-b16", tiny.TRAIN)
OFFLINE = ("stvqa-fp32.offline-b64", "stvqa-fp32", "offline-b64", tiny.OFFLINE)


def run(cell, seed=31, seconds=0.3):
    workload, config, traffic, kw = cell
    line, out = harness.local(workload, seed, seconds,
                              config=tiny.config(config),
                              traffic=tiny.traffic(traffic, **kw))
    return line


@pytest.mark.parametrize("cell", [TRAIN, OFFLINE], ids=["train", "offline"])
def test_sound_runs_are_correct(cell):
    line = run(cell)
    assert line["correct"], line["compared"]


def test_state_left_unchanged(monkeypatch):
    from ruart_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "update", lambda self: None)
    line = run(TRAIN)
    assert not line["correct"]
    assert line["compared"]["train.change"]["value"] > 0.5


def test_half_batch_left_out(monkeypatch):
    from ruart_tpu_torch.train import loss

    make = loss.make_loss_fn

    def half(name):
        fn = make(name)
        return lambda s, l: fn(s[: s.shape[0] // 2], l[: l.shape[0] // 2])

    monkeypatch.setattr(loss, "make_loss_fn", half)
    line = run(TRAIN)
    assert not line["correct"]


def test_offline_answer_altered(monkeypatch):
    from ruart_tpu_torch.eval import evaluator

    decode = evaluator.decode_batch

    def altered(probs, extra, num, *args, **kw):
        res, save, anls, acc = decode(probs, extra, num, *args, **kw)
        save[0] = dict(save[0], prediction=save[0]["prediction"] + "x")
        return res, save, anls, acc

    monkeypatch.setattr(evaluator, "decode_batch", altered)
    line = run(OFFLINE)
    assert not line["correct"]
    assert line["compared"]["offline.choice"]["value"] > 0.01

