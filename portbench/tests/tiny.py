"""Tiny versions of the cells' files, for runs on the CPU."""

import copy

from portbench import build

# the shipped conf's caps and widths scaled down (the port's TINY_OVERRIDES)
TINY_CONF = dict(
    max_ocr_num=12, max_od_num=5, max_ocr_len=6, max_od_len=4,
    max_ocr_bert_len=10, max_od_bert_len=8, max_q_len=9, max_q_bert_len=12,
    hidden_size=8, multi2one_hidden_size=16, highlvl_hidden_size=8,
    deep_att_hidden_size_per_abstr=12, query_self_attn_hidden_size=10,
    prealign_hidden=16, ES_ocr_len=3, glove_dim=16, fast_dim=16,
)
TINY_BERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64)
TINY_CORPUS = dict(ocr_words=[3, 8], od_objects=[1, 4], es_words=10)


def config(name):
    c = copy.deepcopy(build.read_json("configs", name))
    c["conf"] = dict(TINY_CONF, **{k: v for k, v in c["conf"].items()
                                   if k not in TINY_CONF})
    c["bert"].update(TINY_BERT)
    return c


def traffic(name, **kw):
    t = copy.deepcopy(build.read_json("traffic", name))
    t.update(kw)
    t["corpus"] = dict(t["corpus"], **TINY_CORPUS)
    return t


TRAIN = dict(items=48, batch_size=4, max_steps_per_s=4)
OFFLINE = dict(items=24, batch_size=8, checked_batches=2)
