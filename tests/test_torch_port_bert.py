"""The port's BERT encoder (ruart_tpu_torch/models/bert/model.py) against
the flax one, at BertConfig.tiny, on the same weights (flax init ->
convert.from_jax_params) and the same token rows: dense rows with an
attention mask, segment-packed rows, and the fused q + OCR + OD rows
``_fused_bert`` builds. Tolerance 1e-5 abs.

Packed rows compare at real tokens: a pad query of the segment form has
every key masked, and its output (never read downstream) rounds
``score - 10000`` in fp32, which depends on the summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.bert.model import BertModel as JaxBertModel
from ruart_tpu.models.bert.model import linear_combine as jax_linear_combine
from ruart_tpu.models.bert.model import (
    subword_to_word_pooling as jax_pooling,
)
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.bert.model import (
    BertModel,
    linear_combine,
    subword_to_word_pooling,
)

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = 60


@pytest.fixture(scope="module")
def models():
    """The flax model's jitted ``apply`` (one compile per input signature
    instead of one per operation), its init and the port's model."""
    jm = JaxBertModel(JaxBertConfig.tiny(vocab_size=VOCAB))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids)
    tm = BertModel(BertConfig.tiny(vocab_size=VOCAB))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return jax.jit(jm.apply), params, tm.eval()


def _dense_rows(rng, R, L):
    lens = rng.randint(1, L + 1, size=R)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = rng.randint(5, VOCAB, size=(R, L)) * mask
    return ids.astype(np.int32), mask


def _packed_rows(rng, R, L):
    ids = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    pos = np.zeros((R, L), np.int32)
    for r in range(R):
        fill, p, s = rng.randint(L // 2, L + 1), 0, 1
        while p < fill:
            n = min(rng.randint(1, 6), fill - p)
            ids[r, p:p + n] = rng.randint(5, VOCAB, size=n)
            seg[r, p:p + n] = s
            pos[r, p:p + n] = np.arange(n)
            p, s = p + n, s + 1
    return ids, seg, pos


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def test_dense_rows(models):
    apply, params, tm = models
    ids, mask = _dense_rows(np.random.RandomState(0), 5, 12)
    j_layers, j_pooled = apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        t_layers, t_pooled = tm(_t(ids), _t(mask))
    np.testing.assert_allclose(t_layers.numpy(), np.asarray(j_layers),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("combine", [False, True], ids=["layers", "combined"])
def test_segment_packed_rows(models, combine):
    apply, params, tm = models
    ids, seg, pos = _packed_rows(np.random.RandomState(1), 4, 16)
    w = np.array(jax.nn.softmax(jnp.arange(3.0)) * 0.7, np.float32)
    jw = jnp.asarray(w) if combine else None
    tw = torch.from_numpy(w) if combine else None
    j_out, _ = apply(params, jnp.asarray(ids), None, combine_weights=jw,
                        segment_ids=jnp.asarray(seg), position_ids=jnp.asarray(pos))
    with torch.no_grad():
        t_out, _ = tm(_t(ids), None, combine_weights=tw, segment_ids=_t(seg),
                      position_ids=_t(pos))
    real = seg > 0
    np.testing.assert_allclose(t_out.numpy()[..., real, :],
                               np.asarray(j_out)[..., real, :],
                               atol=TOL, rtol=0)


def test_fused_q_ocr_od_rows(models):
    """q rows join in segment form (seg = mask, pos = arange) beside the
    packed OCR and OD tables, as RUArtModel._fused_bert concatenates them."""
    apply, params, tm = models
    rng = np.random.RandomState(2)
    q_ids, q_mask = _dense_rows(rng, 3, 16)
    q_pos = np.broadcast_to(np.arange(16, dtype=np.int32), q_ids.shape)
    blocks = [(q_ids, q_mask, q_pos), _packed_rows(rng, 4, 16),
              _packed_rows(rng, 2, 16)]
    ids, seg, pos = (np.concatenate([b[i] for b in blocks]) for i in range(3))
    w = np.full(3, 1 / 3, np.float32)
    j_out, j_pooled = apply(
        params, jnp.asarray(ids), None, combine_weights=jnp.asarray(w),
        segment_ids=jnp.asarray(seg), position_ids=jnp.asarray(pos),
    )
    with torch.no_grad():
        t_out, t_pooled = tm(_t(ids), None, combine_weights=torch.from_numpy(w),
                             segment_ids=_t(seg), position_ids=_t(pos))
    real = seg > 0
    np.testing.assert_allclose(t_out.numpy()[real], np.asarray(j_out)[real],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled),
                               atol=TOL, rtol=0)


def test_subword_to_word_pooling():
    """Spans of length 0, 1 and > 1, masked words, a leading layer axis."""
    rng = np.random.RandomState(3)
    emb = rng.randn(2, 3, 10, 6).astype(np.float32)      # [layers, B, Lb, D]
    st = rng.randint(0, 10, size=(3, 5))
    ed = np.minimum(st + rng.randint(0, 4, size=(3, 5)), 10)
    offsets = np.stack([st, ed], -1).astype(np.int32)
    word_mask = (rng.rand(3, 5) > 0.3).astype(np.float32)
    want = jax_pooling(jnp.asarray(emb), jnp.asarray(offsets),
                       jnp.asarray(word_mask))
    got = subword_to_word_pooling(torch.from_numpy(emb), _t(offsets),
                                  torch.from_numpy(word_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_linear_combine():
    rng = np.random.RandomState(4)
    layers = rng.randn(4, 2, 5, 3).astype(np.float32)
    alpha = rng.randn(4).astype(np.float32)
    gamma = np.array([[1.3]], np.float32)
    want = jax_linear_combine(*(jnp.asarray(x) for x in (layers, alpha, gamma)))
    got = linear_combine(*(torch.from_numpy(x) for x in (layers, alpha, gamma)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
