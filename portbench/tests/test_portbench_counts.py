"""The FLOP counts against ``torch.utils.flop_counter.FlopCounterMode`` on
the frozen reference at a tiny size: the count's formulas fed the padded
sizes the reference computes on give the products it runs. (In a run they
are fed the real sizes.) The LSTMs, which the counter does not see, follow
their written formula."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import check, corpus, counts
from portbench.tests import tiny


def reference_batch(name, n=4):
    config = tiny.config(name)
    raw = corpus.make_items(n, 5, tiny.TINY_CORPUS, with_answers=True)
    ref = check.Reference(config, {"batch_size": n}, "cpu", 3)
    ds = ref.featurize(raw, raw, "train")
    ref.build_model()
    return ref, ref.collate([ds[i] for i in range(n)])


def counted(ref, batch, monkeypatch):
    """(all products, the encoder's, the word pooling's) the counter sees
    in one forward of the reference."""
    import portbench.reference.model as model_module

    pooling = []
    pool = model_module.subword_to_word_pooling

    def recorded(emb, offsets, mask):
        pooling.append(2 * offsets.shape[0] * offsets.shape[1]
                       * emb.shape[-2] * emb.shape[-1])
        return pool(emb, offsets, mask)

    monkeypatch.setattr(model_module, "subword_to_word_pooling", recorded)
    q, ocr, od = (ref.to_device(b) for b in batch[:3])
    with FlopCounterMode(display=False) as f, torch.no_grad():
        ref.model.eval()
        ref.model(q, ocr, od)
    per = f.get_flop_counts()
    bert = sum(sum(v.values()) for k, v in per.items()
               if k.split(".")[-1] == "Bert" and k.count(".") == 1)
    return sum(per["Global"].values()), bert, sum(pooling)


def padded_sizes(batch):
    q, ocr, od = batch[:3]
    B, Lq = np.asarray(q["fasttext"]).shape
    s = {"q": np.full(B, float(Lq))}
    for name, block in (("ocr", ocr), ("od", od)):
        _, N, L = np.asarray(block["fasttext"]).shape
        rows = len(block["cand_sel"]) if "cand_sel" in block else B * N
        s[name] = np.full(B, float(N))
        s[name + "_words"] = np.full(B, rows * L / B)
    return s


def test_encoder_rows_count_real_tokens():
    block = {"bert_packed": np.array([[5, 6, 7, 8, 0], [9, 9, 0, 0, 0]]),
             "bert_packed_seg": np.array([[1, 1, 2, 2, 0], [1, 1, 0, 0, 0]])}
    assert counts.bert_rows(block) == (6, 4 + 4 + 4, 2)
    dense = {"bert": np.array([[[2, 5, 3, 0]], [[0, 0, 0, 0]]])}
    assert counts.bert_rows(dense) == (3, 9, 1)


@pytest.mark.parametrize("name", ["stvqa-fp32"])
def test_products_match_the_counter(name, monkeypatch):
    ref, batch = reference_batch(name)
    total, bert, pooling = counted(ref, batch, monkeypatch)
    assert bert > 0 and pooling > 0
    fusion = counts.fusion_flops(ref.model, padded_sizes(batch))
    # the word pooling (a mean over each word's pieces, a matmul in the
    # model) is the one product the count leaves out
    assert fusion == total - bert - pooling


def test_encoder_matches_the_counter_on_full_rows():
    from portbench.reference.bert import BertModel
    from portbench.reference.bert_config import BertConfig

    c = BertConfig(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   attention_impl="plain")
    model = BertModel(c).eval()
    ids = torch.randint(5, 100, (3, 7))
    with FlopCounterMode(display=False) as f, torch.no_grad():
        model(ids, torch.ones_like(ids))
    want = counts.bert_flops([{"bert": ids.numpy()}], 32, 64, 2)
    assert f.get_total_flops() == want


def test_lstm_formula():
    from portbench.reference.rnn import StackedBRNN

    stack = StackedBRNN(10, 7, 2)
    # two layers, both directions: 2 * 4H(I + H) per step each
    per_step = 2 * (8 * 7 * (10 + 7)) + 2 * (8 * 7 * (14 + 7))
    assert counts.stack_flops(stack, 5) == 5 * per_step


def test_real_sizes_count_less_than_padded():
    ref, batch = reference_batch("stvqa-fp32")
    real = counts.fusion_sizes(*batch[:3])
    assert counts.fusion_flops(ref.model, real) <= counts.fusion_flops(
        ref.model, padded_sizes(batch))
