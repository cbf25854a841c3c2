"""Built-in configuration presets.

``STVQA_CONF`` carries the semantics-bearing keys of the reference's
shipped ST-VQA task-3 conf (its `conf` file minus data paths), so the
flagship model can be constructed without external files. ``TINY_OVERRIDES``
scales every dimension down for tests, CPU dryruns and CI. Copy of
``ruart_tpu/core/presets.py``.
"""

STVQA_CONF = """\
Task   test
score_name ANLS
lable_way   lable_all_with_threshold
score_threshold 0.5
mask_score
label_no_answer
max_ocr_num 100
max_od_num  30
max_ocr_len 20
max_od_len  10
max_ocr_bert_len    30
max_od_bert_len 10
max_q_len   40
max_q_bert_len  50
GLOVE
glove_dim 300
FastText
fast_dim 300
q_embedding glove,pos,ent,bert
ocr_embedding  fasttext,pos,ent,bert
q_emb_initial glove
ocr_emb_initial  fasttext
loss    BCE_D1
optimizer   #
batch_size  16
lr 0.001
max_batch_num	3000
epoch 30
LN
DROPOUT	0.3
VARIATIONAL_DROPOUT
BERT
dropout_emb	0.4
LOCK_BERT
BERT_LINEAR_COMBINE
SEED	1033
QUES_SELF_ATTN
concat_rnn	False
grad_clipping	 10
do_seq_dropout
TUNE_PARTIAL
tune_partial	1000
embedding_dim	300
prealign_hidden	300
PRE_ALIGN
PRE_ALIGN_befor_rnn
pos_dim	12
ent_dim	8
query_self_attn_hidden_size	300
hidden_size	125
deep_att_hidden_size_per_abstr	250
in_rnn_layers	2
highlvl_hidden_size	125
question_high_lvl_rnn_layers	1
multi2one_hidden_size   300
multi2one_bidir False
position_dim    8
position_mod    qk+
pos_att_merge_mod   cat
n_gram  2
ocr_name_list   ocr_PMTD_ASTER,ocr_PMTD_ASTER_gram2
od_name_list OD_bottom-up
useES
ES_ocr  ES_ocr
ES_ocr_len  10
ES_sort_way frequency
ES_using_way    as_ocr
BuildTestVocabulary
"""

# Scaled-down dimensions for tests / CPU dryruns. The word-vector dim must
# equal the multi2one output width (shipped conf: 300 == 300).
TINY_OVERRIDES = dict(
    max_ocr_num=12, max_od_num=5, max_ocr_len=6, max_od_len=4,
    max_ocr_bert_len=10, max_od_bert_len=8, max_q_len=9, max_q_bert_len=12,
    hidden_size=8, multi2one_hidden_size=16, highlvl_hidden_size=8,
    deep_att_hidden_size_per_abstr=12, query_self_attn_hidden_size=10,
    prealign_hidden=16, ES_ocr_len=3, vocab_size=50,
    glove_dim=16, fast_dim=16,
)


def stvqa_config(**overrides):
    from ruart_tpu_torch.core.config import Config, read_conf_lines

    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(overrides)
    return Config(opt)


def tiny_config(**overrides):
    opt_overrides = dict(TINY_OVERRIDES)
    opt_overrides.update(overrides)
    return stvqa_config(**opt_overrides)
