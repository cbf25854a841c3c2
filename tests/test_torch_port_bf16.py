"""``BF16`` in the port against the JAX package on the CPU: the encoder in
bf16 over fp32 weights, the fusion stack in fp32.

The JAX side is compiled with ``xla_allow_excess_precision`` off, so XLA
rounds to bf16 where the JAX program says (at the output of each op whose
type is bf16), as its eager evaluation does and as the port does. With
the option on (XLA's default) fusion keeps some bf16 intermediates in
fp32: at this size the scores then move by 2.6e-3 from the program's own
result, more than bf16 moves them from fp32 (1.9e-3), and no eager code
can follow a compiler's fusion choices.

The limit each check states is relative to what bf16 itself does to the
JAX result:

    max |port_bf16 - jax_bf16| <= 2 * max |jax_bf16 - jax_fp32|

(measured here: ~2e-7 against ~2e-3 on the scores). Checked for the
encoder's α-combined output (packed rows under the segment bias, at real
tokens), for the model's scores (also under ``INT8_BERT``), for the loss
of one train step with ``LOCK_BERT`` off, and for the attention's
gradients in bf16 (the port's ``autograd.Function`` against the VJP of
the JAX package's ``attention_rows_xla``). Weights: the port's seeded
init, carried to flax by ``convert.to_jax_params``; inputs from numpy
seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.core.config import read_conf_lines
from ruart_tpu.core.presets import STVQA_CONF, TINY_OVERRIDES
from ruart_tpu.data.synthetic import make_synthetic_batch
from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.bert.model import BertModel as JaxBertModel
from ruart_tpu.models.fusion.model import RUArtModel as JaxRUArtModel
from ruart_tpu.models.fusion.spec import ModelSpec as JaxModelSpec
from ruart_tpu.ops.attention import attention_rows_xla
from ruart_tpu.ops.quant import quantize_bert_params as jax_quantize
from ruart_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from ruart_tpu.train.optim import make_optimizer as jax_make_optimizer
from ruart_tpu.train.optim import make_row_pinner as jax_make_row_pinner
from ruart_tpu.train.train_step import init_train_state as jax_init_state
from ruart_tpu.train.train_step import make_train_step as jax_make_train_step
from ruart_tpu_torch.convert import from_jax_params, to_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops import attention as att
from ruart_tpu_torch.ops.quant import quantize_bert_params
from ruart_tpu_torch.train.loss import make_loss_fn
from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
from ruart_tpu_torch.train.train_step import init_train_state, make_train_step

torch.set_num_threads(2)
VOCAB = 64
LR = 1e-3


def as_written(jitted, *args):
    """``jitted(*args)``, compiled with bf16 rounded where the program
    says (see the module docstring)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def within_rule(port_bf16, jax_bf16, jax_fp32, what):
    moved = float(np.abs(np.float64(jax_bf16) - np.float64(jax_fp32)).max())
    diff = float(np.abs(np.float64(port_bf16) - np.float64(jax_bf16)).max())
    assert moved > 0, f"{what}: bf16 does not move the JAX result"
    assert diff <= 2 * moved, (
        f"{what}: max |port_bf16 - jax_bf16| = {diff:.3e} exceeds twice "
        f"max |jax_bf16 - jax_fp32| = {moved:.3e}")


def _opt(**changes):
    opt = read_conf_lines(STVQA_CONF.splitlines())
    opt.update(TINY_OVERRIDES)
    for key in ("DROPOUT", "dropout_emb"):  # the same function in both
        opt.pop(key)
    for key, value in changes.items():
        if value is None:
            opt.pop(key, None)
        else:
            opt[key] = value
    return opt


def _specs(**changes):
    opt = _opt(**changes)
    two_layers = dict(vocab_size=VOCAB, num_hidden_layers=2)
    return (JaxConfig(opt),
            JaxModelSpec.from_config(JaxConfig(opt), dataclasses.replace(
                JaxBertConfig.tiny(), **two_layers)),
            ModelSpec.from_config(Config(opt), dataclasses.replace(
                BertConfig.tiny(), **two_layers)))


@pytest.fixture(scope="module")
def setup():
    """fp32 weights (flax tree), one synthetic batch, its targets and the
    JAX package's fp32 scores."""
    cfg, jspec, spec = _specs()
    q, ocr, od, gt = make_synthetic_batch(jspec, cfg, 2, seed=0)
    port = RUArtModel(spec).init_weights(torch.Generator().manual_seed(0))
    params = to_jax_params(port)
    return params, (q, ocr, od), gt, _jax_scores(params, (q, ocr, od))


def _jax_scores(params, batch, **changes):
    _, jspec, _ = _specs(**changes)
    jb = [jax.tree.map(jnp.asarray, t) for t in batch]
    return np.asarray(as_written(jax.jit(JaxRUArtModel(jspec).apply),
                                 jax.tree.map(jnp.asarray, params), *jb))


def _port_model(state, **changes):
    model = RUArtModel(_specs(**changes)[2])
    model.load_state_dict(state)
    return model


def _torch(batch):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            for b in batch]


def test_bf16_conf_reaches_the_encoder():
    spec = _specs(BF16=True)[2]
    assert spec.bert.dtype == "bfloat16"
    model = RUArtModel(spec)
    assert model.Bert.embeddings.dtype == torch.bfloat16
    # the weights stay fp32: the state dict and the checkpoints do not change
    assert {t.dtype for t in model.state_dict().values()} == {torch.float32}


def test_encoder_output_matches_jax(setup, monkeypatch):
    """The α-combined encoder output on packed rows (segment bias), K1's
    serving-path input; the attention sees bf16 q/k/v and an fp32 bias."""
    params = setup[0]["params"]
    rng = np.random.RandomState(3)
    R, L = 6, 16
    ids = np.zeros((R, L), np.int32)
    seg = np.zeros((R, L), np.int32)
    pos = np.zeros((R, L), np.int32)
    for r in range(R):
        p, s = 0, 1
        while p < rng.randint(L // 2, L + 1):
            n = min(rng.randint(2, 6), L - p)
            ids[r, p:p + n] = rng.randint(5, VOCAB, size=n)
            seg[r, p:p + n], pos[r, p:p + n] = s, np.arange(n)
            p, s = p + n, s + 1
    w = np.array(jax.nn.softmax(jnp.asarray(params["alphaBERT"])))
    real = seg > 0

    def jax_out(dtype):
        cfg = dataclasses.replace(_specs()[1].bert, dtype=dtype)
        encode = jax.jit(lambda p, i, s, q, c: JaxBertModel(cfg).apply(
            p, i, None, segment_ids=s, position_ids=q, combine_weights=c)[0])
        return np.asarray(as_written(
            encode, {"params": jax.tree.map(jnp.asarray, params["Bert"])},
            *(jnp.asarray(x) for x in (ids, seg, pos, w))))[real]

    seen = []

    def recording(q, k, v, bias, heads):
        seen.append((q.dtype, k.dtype, v.dtype, bias.dtype))
        return att.attention_rows_plain(q, k, v, bias, heads)

    monkeypatch.setattr(att, "attention_rows", recording)
    model = _port_model(from_jax_params(setup[0]), BF16=True).eval()
    with torch.no_grad():
        got = model.Bert(torch.from_numpy(ids).long(), None,
                         combine_weights=torch.from_numpy(w),
                         segment_ids=torch.from_numpy(seg).long(),
                         position_ids=torch.from_numpy(pos).long())[0]
    assert got.dtype == torch.float32
    assert seen and set(seen) == {(torch.bfloat16,) * 3 + (torch.float32,)}
    within_rule(got.numpy()[real], jax_out("bfloat16"), jax_out("float32"),
                "encoder output")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "bf16+int8"])
def test_scores_match_jax(setup, int8):
    params, batch, _, want_fp32 = setup
    state = from_jax_params(params)
    extra = {"INT8_BERT": True} if int8 else {}
    if int8:
        params = jax.tree.map(np.asarray, jax_quantize(params))
        state = quantize_bert_params(state)
        assert all(torch.equal(from_jax_params(params)[k], v)
                   for k, v in state.items())
        want_fp32 = _jax_scores(params, batch, **extra)
    want_bf16 = _jax_scores(params, batch, BF16=True, **extra)
    with torch.no_grad():
        got = _port_model(state, BF16=True, **extra).eval()(*_torch(batch))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    within_rule(got.numpy(), want_bf16, want_fp32, "scores")


def test_unlocked_train_step_matches_jax(setup):
    """One train step with BF16 and LOCK_BERT off: the loss to the rule; the
    encoder's fp32 weights get finite, non-zero gradients through the bf16
    forward and the attention's autograd.Function."""
    params, batch, gt, scores_fp32 = setup
    want_fp32 = float(jax_make_loss_fn("BCE_D1")(
        jnp.asarray(scores_fp32), jnp.asarray(gt)))

    cfg, jspec, spec = _specs(BF16=True, LOCK_BERT=None)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = jax_make_optimizer("#", LR, 10.0, jparams, jspec, True)
    step = jax_make_train_step(
        JaxRUArtModel(jspec), tx, jax_make_loss_fn("BCE_D1"),
        jax_make_row_pinner(jparams, jspec, 1000), donate=False)
    _, want_bf16 = as_written(step, jax_init_state(jparams, tx, cfg.seed),
                              *(jax.tree.map(jnp.asarray, t) for t in batch),
                              jnp.asarray(gt))

    model = _port_model(from_jax_params(params), BF16=True, LOCK_BERT=None)
    tx = Optimizer("#", LR, 10.0, model, spec, True)
    step = make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(model, spec, 1000))
    _, got = step(init_train_state(model, tx, cfg.seed), *_torch(batch),
                  torch.from_numpy(gt))
    within_rule(np.float64(float(got)), np.float64(float(want_bf16)),
                np.float64(want_fp32), "train-step loss")
    grads = [p.grad for n, p in model.named_parameters()
             if n.startswith("Bert.layer_")]
    assert grads and all(g is not None and g.dtype == torch.float32
                         and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def test_attention_gradients_in_bf16():
    """The autograd.Function's bf16 backward (the VJP of the plain
    version, as ``_fused_attention_bwd`` recomputes through
    ``attention_rows_xla``) against the JAX VJP; the gradients come back
    in bf16, the fp32 bias gets none."""
    rng = np.random.RandomState(4)
    B, L, H, dh = 3, 12, 4, 8
    q, k, v, g = (rng.randn(B, L, H * dh).astype(np.float32) for _ in range(4))
    bias = np.where(rng.rand(B, L) < 0.2, -10000.0, 0.0).astype(np.float32)
    bias[:, 0] = 0.0

    def jax_grads(dtype):
        def grads(a, b, c, cot):
            _, vjp = jax.vjp(lambda a, b, c: attention_rows_xla(
                a, b, c, jnp.asarray(bias), H), a, b, c)
            return vjp(cot)

        return [np.asarray(x, np.float32) for x in as_written(
            jax.jit(grads), *(jnp.asarray(x, dtype) for x in (q, k, v, g)))]

    leaves = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    tbias = torch.from_numpy(bias)
    out = att.fused_attention(*leaves, tbias, H)
    assert out.dtype == torch.bfloat16 and tbias.dtype == torch.float32
    out.backward(torch.from_numpy(g).bfloat16())
    assert tbias.grad is None
    for name, leaf, want_bf16, want_fp32 in zip(
            "qkv", leaves, jax_grads(jnp.bfloat16), jax_grads(jnp.float32)):
        assert leaf.grad.dtype == torch.bfloat16
        within_rule(leaf.grad.float().numpy(), want_bf16, want_fp32,
                    f"d{name}")
