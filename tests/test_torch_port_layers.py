"""The port's fusion layers and LSTM stacks (ruart_tpu_torch/models/fusion/
{layers,rnn,deep_attention}.py) against the flax modules, module by
module, on the same weights (flax init -> convert.from_jax_params) and the
same numpy inputs. Tolerance 1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.models.fusion import deep_attention as jda
from ruart_tpu.models.fusion import layers as jl
from ruart_tpu.models.fusion import rnn as jrnn
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.models.fusion import deep_attention as tda
from ruart_tpu_torch.models.fusion import layers as tl
from ruart_tpu_torch.models.fusion import rnn as trnn

torch.set_num_threads(2)
TOL = 1e-5


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _mask(rng, B, L, all_masked_row=False):
    n = rng.randint(1, L + 1, size=B)
    m = (np.arange(L)[None] < n[:, None]).astype(np.float32)
    if all_masked_row:
        m[0] = 0.0
    return m


def _pair(flax_module, torch_module, *args, **kw):
    """Init the flax module on ``args``, load its params into the torch
    module; returns (flax output, torch output) as numpy."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    params = flax_module.init(jax.random.PRNGKey(0), *jargs, **kw)
    want = flax_module.apply(params, *jargs, **kw)
    torch_module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items() if k != "deterministic"}
    with torch.no_grad():
        got = torch_module(*targs, **tkw)
    return want, got


def _close(got, want):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_masked_softmax_and_weighted_avg():
    rng = np.random.RandomState(0)
    s, m = _rand(rng, 3, 7), _mask(rng, 3, 7, all_masked_row=True)
    _close(tl.masked_softmax(torch.from_numpy(s), torch.from_numpy(m)),
           jl.masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    x, w = _rand(rng, 3, 7, 5), _rand(rng, 3, 7)
    _close(tl.weighted_avg(torch.from_numpy(x), torch.from_numpy(w)),
           jl.weighted_avg(jnp.asarray(x), jnp.asarray(w)))


def test_whole_tensor_layer_norm():
    x = _rand(np.random.RandomState(1), 2, 6, 4) * 3 + 1
    _close(tl.whole_tensor_layer_norm(torch.from_numpy(x)),
           jl.whole_tensor_layer_norm(jnp.asarray(x)))


@pytest.mark.parametrize("cf,sim", [(1, False), (2, False), (3, False),
                                    (3, True), (4, False), (5, False)])
def test_attention_score(cf, sim):
    rng = np.random.RandomState(cf)
    x1, x2 = _rand(rng, 2, 5, 6), _rand(rng, 2, 4, 6)
    want, got = _pair(jl.AttentionScore(7, cf, sim),
                      tl.AttentionScore(6, 7, cf, sim), x1, x2)
    _close(got, want)


def test_attention_with_values_and_masked_row():
    rng = np.random.RandomState(2)
    x1, x2, x3 = _rand(rng, 3, 5, 6), _rand(rng, 3, 4, 6), _rand(rng, 3, 4, 2)
    m = _mask(rng, 3, 4, all_masked_row=True)
    want, got = _pair(jl.Attention(7, 3), tl.Attention(6, 7, 3),
                      x1, x2, m, x3=x3)
    _close(got, want)


def test_attention_row_index_form():
    """Gathered x1 rows attend to their own batch row of x2 (the pre-align
    call under candidate compaction)."""
    rng = np.random.RandomState(3)
    x1, x2 = _rand(rng, 5, 4, 6), _rand(rng, 2, 3, 6)
    m = _mask(rng, 2, 3)
    idx = np.array([0, 1, 1, 0, 1], np.int64)
    want, got = _pair(jl.Attention(7, 3, do_similarity=True),
                      tl.Attention(6, 7, 3, do_similarity=True),
                      x1, x2, m, x2_row_index=idx)
    _close(got, want)


def test_linear_self_attn():
    rng = np.random.RandomState(4)
    x, m = _rand(rng, 3, 5, 6), _mask(rng, 3, 5)
    want, got = _pair(jl.LinearSelfAttn(), tl.LinearSelfAttn(6), x, m)
    _close(got, want)


@pytest.mark.parametrize("mask_flag", [True, False])
def test_bilinear_seq_attn(mask_flag):
    rng = np.random.RandomState(5)
    x, y, m = _rand(rng, 3, 5, 6), _rand(rng, 3, 4), _mask(rng, 3, 5)
    want, got = _pair(jl.BilinearSeqAttn(6), tl.BilinearSeqAttn(6, 4),
                      x, y, m, mask_flag)
    _close(got, want)


@pytest.mark.parametrize("use_es,yesno,no_answer",
                         [(True, False, True), (False, True, True),
                          (False, False, False)],
                         ids=["es-noanswer", "yesno-noanswer", "plain"])
def test_get_final_scores(use_es, yesno, no_answer):
    rng = np.random.RandomState(6)
    x, h, m = _rand(rng, 3, 8, 6), _rand(rng, 3, 4), _mask(rng, 3, 8)
    kw = dict(es_len=3, mask_flag=True) if use_es else dict(mask_flag=True)
    want, got = _pair(
        jl.GetFinalScores(6, 4, yesno=yesno, no_answer=no_answer, use_es=use_es),
        tl.GetFinalScores(6, 4, yesno=yesno, no_answer=no_answer, use_es=use_es),
        x, h, m, **kw,
    )
    _close(got, want)


@pytest.mark.parametrize("bidir,layers,concat,ln", [
    (True, 2, False, True), (False, 1, False, False), (True, 2, True, True),
], ids=["bi-ln", "uni", "bi-concat"])
def test_stacked_brnn(bidir, layers, concat, ln):
    x = _rand(np.random.RandomState(7), 3, 9, 5)
    want, got = _pair(
        jrnn.StackedBRNN(4, layers, bidirectional=bidir, concat_layers=concat),
        trnn.StackedBRNN(5, 4, layers, bidirectional=bidir,
                         concat_layers=concat),
        x, deterministic=True, ln=ln, return_list=True,
    )
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_gather_last_state_with_empty_rows():
    out = _rand(np.random.RandomState(8), 4, 6, 3)
    lens = np.array([3, 0, 6, 1], np.int64)
    _close(trnn.gather_last_state(torch.from_numpy(out), torch.from_numpy(lens)),
           jrnn.gather_last_state(jnp.asarray(out), jnp.asarray(lens)))


def test_deep_attention():
    rng = np.random.RandomState(9)
    B, Lx, Ly, W, A, Q = 2, 5, 4, 6, 8, 10
    x1_word, x2_word = [_rand(rng, B, Lx, W)], [_rand(rng, B, Ly, W)]
    x1_abstr = [_rand(rng, B, Lx, A) for _ in range(2)]
    x2_abstr = [_rand(rng, B, Ly, A) for _ in range(2)] + [_rand(rng, B, Ly, Q)]
    m1, m2 = _mask(rng, B, Lx), _mask(rng, B, Ly)
    jm = jda.DeepAttention(2, 7, 5)
    tm = tda.DeepAttention(W + 2 * A, [A, A, Q], 2 * A, 7, 5)
    jargs = [[jnp.asarray(a) for a in g] for g in
             (x1_word, x1_abstr, x2_word, x2_abstr)]
    params = jm.init(jax.random.PRNGKey(0), *jargs, jnp.asarray(m1),
                     jnp.asarray(m2))
    want = jm.apply(params, *jargs, jnp.asarray(m1), jnp.asarray(m2),
                    return_bef_rnn=True)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(*[[torch.from_numpy(a) for a in g] for g in
                   (x1_word, x1_abstr, x2_word, x2_abstr)],
                 torch.from_numpy(m1), torch.from_numpy(m2))
    _close(got, want)
