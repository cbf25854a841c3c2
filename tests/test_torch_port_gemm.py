"""G1, the encoder's fp32 Linears in 3xTF32 (ruart_tpu_torch/csrc/
gemm_tf32x3.cu, ruart_tpu_torch/ops/gemm.py), on the CPU.

(a) The kernel's arithmetic, emulated in torch: x = big + small with big =
cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big) (the rounding of
``test_torch_port_tf32_split.py``), and x w^T ~ small*big + big*small +
big*big in fp32, small terms first. At BERT-base's product shapes, with
inputs drawn from a seed off any grid, it keeps fp32's accuracy against an
fp64 product, and one encoder layer whose six Linears take it stays within
1e-5 abs of the JAX package's BERT layer; one TF32 product per fp32
product misses by ten times more. (b) Which Linears route to the op: the
six of each encoder layer in fp32 (Q, K and V in one call), not the BF16
or INT8_BERT encoder, the pooler or the fusion stack; what the op refuses;
its launch counter among ``ops.attention``'s. (c) The autograd path's
gradients against ``F.linear``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ruart_tpu.models.bert.config import BertConfig as JaxBertConfig
from ruart_tpu.models.bert.model import BertModel as JaxBertModel
from ruart_tpu_torch.convert import from_jax_params
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.models.bert import model as bert
from ruart_tpu_torch.models.bert.config import BertConfig
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops import attention as att
from ruart_tpu_torch.ops import gemm
from tests.test_torch_port_tf32_split import split, tf32
from test_torch_port_slice import VOCAB_SIZE, _opt

torch.set_num_threads(2)
TOL = 1e-5
MIN_RATIO = 10.0  # one TF32 product misses by at least this many times more
SHAPES = [(2304, 768), (3072, 768), (768, 3072)]  # (N, K): QKV, FFN in, out


def linear_3xtf32(x, w, b=None):
    """x w^T (+ b) as the kernel computes it: small terms first."""
    x_big, x_small = split(x)
    w_big, w_small = split(w)
    y = (x_small @ w_big.t() + x_big @ w_small.t()) + x_big @ w_big.t()
    return y if b is None else y + b


def linear_1xtf32(x, w, b=None):
    y = tf32(x) @ tf32(w).t()
    return y if b is None else y + b


def emulated(product):
    """A stand-in for ``gemm.linear_many`` on CPU tensors that multiplies
    through ``product``."""

    def linear_many(x, weights, biases, gelu=False):
        ys = tuple(product(x, w, b) for w, b in zip(weights, biases))
        return tuple(F.gelu(y) for y in ys) if gelu else ys

    return linear_many


def _scaled_error(y, x, w):
    """max |y - x w^T| / (|x| |w|^T), the product in fp64."""
    ref = x.double() @ w.double().t()
    scale = x.double().abs() @ w.double().abs().t()
    return ((y.double() - ref).abs() / scale).max().item()


@pytest.mark.parametrize("M", [200, 1000])
@pytest.mark.parametrize("N,K", SHAPES, ids=[f"{n}x{k}" for n, k in SHAPES])
def test_split_product_keeps_fp32_accuracy(M, N, K):
    rng = np.random.RandomState(M + N + K)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(N, K) * 0.02).astype(np.float32))
    three = _scaled_error(linear_3xtf32(x, w), x, w)
    one = _scaled_error(linear_1xtf32(x, w), x, w)
    fp32 = _scaled_error(x @ w.t(), x, w)
    assert three <= 4 * fp32 + 1e-7, (three, fp32)
    assert one >= MIN_RATIO * three, (one, three)


@pytest.fixture(scope="module")
def base_layer():
    """One BERT-base layer (768 wide, 12 heads, FFN 3072) of the JAX
    package, its params, and the port's model on the same weights."""
    kw = dict(vocab_size=60, num_hidden_layers=1, attention_impl="xla")
    jm = JaxBertModel(JaxBertConfig(**kw))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids)
    tm = bert.BertModel(BertConfig(vocab_size=60, num_hidden_layers=1))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return jax.jit(jm.apply), params, tm.eval()


@pytest.mark.parametrize("B,L", [(4, 50), (10, 100)], ids=["M200", "M1000"])
def test_layer_on_the_split_product_matches_jax(base_layer, monkeypatch, B, L):
    apply, params, tm = base_layer
    rng = np.random.RandomState(B)
    lens = rng.randint(L // 2, L + 1, size=B)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(5, 60, size=(B, L)) * mask).astype(np.int32)
    want = np.asarray(apply(params, jnp.asarray(ids), jnp.asarray(mask))[0][0])
    errs = {}
    for name, product in (("3xtf32", linear_3xtf32),
                          ("1xtf32", linear_1xtf32)):
        monkeypatch.setattr(gemm, "linear_many", emulated(product))
        with torch.no_grad():
            got = tm(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long())[0][0]
        errs[name] = np.abs(got.numpy() - want).max()
    assert errs["3xtf32"] <= TOL, errs
    assert errs["1xtf32"] >= MIN_RATIO * errs["3xtf32"], errs


def test_cpu_tensors_take_f_linear(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(gemm, "linear_cuda", no_kernel)
    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(*s, generator=g)
               for s in ((5, 64), (128, 64), (128,)))
    assert torch.equal(gemm.linear(x, w, b), F.linear(x, w, b))
    assert torch.equal(gemm.linear(x, w, b, gelu=True),
                       F.gelu(F.linear(x, w, b)))
    ys = gemm.linear_many(x, [w, w * 2], [b, None])
    assert torch.equal(ys[1], F.linear(x, w * 2))


class _Routed:
    """A counting stand-in for ``gemm.linear_many`` (the plain products)."""

    def __init__(self):
        self.calls, self.weights = [], []

    def __call__(self, x, weights, biases, gelu=False):
        self.calls.append((len(weights), gelu,
                           tuple(b is None for b in biases)))
        self.weights.extend(weights)
        return tuple(gemm.linear_plain(x, w, b, gelu)
                     for w, b in zip(weights, biases))


def _six(model):
    """The weights of the six Linears of every encoder layer."""
    names = ("attention_self.query", "attention_self.key",
             "attention_self.value", "attention_output_dense",
             "intermediate_dense", "output_dense")
    return {id(p) for n, p in model.named_parameters()
            if n.endswith(".weight") and any(s in n for s in names)}


def _tiny_bert(**kw):
    torch.manual_seed(0)
    return bert.BertModel(BertConfig.tiny(vocab_size=60, **kw)).eval()


def _ids():
    return torch.from_numpy(np.random.RandomState(0).randint(5, 60, (3, 7)))


def test_fp32_encoder_linears_route_to_the_op(monkeypatch):
    routed = _Routed()
    monkeypatch.setattr(gemm, "linear_many", routed)
    model = _tiny_bert()
    with torch.no_grad():
        out = model(_ids())
    layers = model.config.num_hidden_layers
    # per layer: Q/K/V in one call, then attention output, intermediate
    # (gelu in the op) and output
    assert routed.calls == [(3, False, (False,) * 3), (1, False, (False,)),
                            (1, True, (False,)), (1, False, (False,))] * layers
    assert {id(w) for w in routed.weights} == _six(model)
    assert id(model.pooler_dense.weight) not in {id(w) for w in routed.weights}
    monkeypatch.undo()
    with torch.no_grad():
        plain = model(_ids())
    assert all(torch.equal(a, b) for a, b in zip(out, plain))


@pytest.mark.parametrize("kw", [dict(dtype="bfloat16"), dict(quant="int8")],
                         ids=["BF16", "INT8_BERT"])
def test_bf16_and_int8_encoders_do_not_route(monkeypatch, kw):
    routed = _Routed()
    monkeypatch.setattr(gemm, "linear_many", routed)
    with torch.no_grad():
        _tiny_bert(**kw)(_ids())
    assert routed.calls == []


def test_pooler_and_fusion_stack_do_not_route(monkeypatch):
    opt = _opt({})
    cfg = Config(opt)
    spec = ModelSpec.from_config(cfg, BertConfig.tiny(vocab_size=VOCAB_SIZE))
    q, ocr, od, _ = make_synthetic_batch(spec, cfg, 2, seed=0)
    model = RUArtModel(spec).eval()
    assert not isinstance(model.Bert.pooler_dense, bert.EncoderLinear)
    routed = _Routed()
    monkeypatch.setattr(gemm, "linear_many", routed)
    blocks = [{k: torch.from_numpy(v) for k, v in t.items()}
              for t in (q, ocr, od)]
    with torch.no_grad():
        model(*blocks)
    assert routed.calls and {id(w) for w in routed.weights} <= _six(model)


def test_row_parallel_linear_routes_without_bias(monkeypatch):
    routed = _Routed()
    monkeypatch.setattr(gemm, "linear_many", routed)
    layer = bert.RowParallelLinear(64, 32, group=None)
    x = torch.randn(4, 64)
    y = layer(x)
    assert routed.calls == [(1, False, (True,))]
    assert torch.allclose(y, F.linear(x, layer.weight, layer.bias), atol=1e-6)


@pytest.mark.parametrize("case", ["bf16", "non-contiguous", "K", "N",
                                  "weight device"])
def test_the_op_refuses(case):
    x, w, b = torch.randn(8, 128), torch.randn(128, 128), torch.randn(128)
    args = {
        "bf16": ((x.bfloat16(), [w.bfloat16()], [b.bfloat16()]), "dtype"),
        "non-contiguous": ((torch.randn(128, 8).t(), [w], [b]), "contiguous"),
        "K": ((x[:, :100].contiguous(), [w[:, :100].contiguous()], [b]),
              "K 100"),
        "N": ((x, [w[:40].contiguous()], [b[:40].contiguous()]), "N 40"),
        # an input on one device, its weight on another (a card's input
        # and a CPU weight; here the meta device stands for the card)
        "weight device": ((x.to("meta"), [w], [b.to("meta")]), "must be on"),
    }
    (xs, ws, bs), match = args[case]
    with pytest.raises(ValueError, match=match):
        gemm._check(xs, ws, bs, device_type=xs.device.type)
    with pytest.raises(ValueError):
        gemm.linear_cuda(xs, ws, bs)


def test_shapes_of_the_encoder_and_its_tp_shards_are_taken():
    for N, K in [(768, 768), (3072, 768), (768, 3072), (384, 768),
                 (1536, 768), (768, 384), (768, 1536)]:
        n = 3 if (N, K) in ((768, 768), (384, 768)) else 1
        x = torch.empty(10, K, device="meta")
        ws = [torch.empty(N, K, device="meta")] * n
        assert gemm._check(x, ws, [None] * n, device_type="meta") == (10, N, K)


@pytest.mark.parametrize("N", [64, 192, 320])
def test_n_off_the_tile_is_refused(N):
    """The kernel's one tile is 128 wide: an N that is no multiple of it
    (a tp 4 shard of BERT-base's 768, say) raises, on every path."""
    x = torch.empty(10, 768, device="meta")
    with pytest.raises(ValueError, match=f"N {N} is not"):
        gemm._check(x, [torch.empty(N, 768, device="meta")], [None],
                    device_type="meta")


@pytest.mark.parametrize("n", [1, 3])
def test_m_past_the_grid_is_refused(n):
    """The grid's y runs over M's 128-row tiles of every weight in turn, up
    to 65,535: the last M that fits is taken, one more row is refused."""
    fits = 65535 // n * 128
    ws = [torch.empty(768, 768, device="meta")] * n
    x = torch.empty(fits, 768, device="meta")
    assert gemm._check(x, ws, [None] * n, device_type="meta")[0] == fits
    with pytest.raises(ValueError, match="exceeds the grid"):
        gemm._check(torch.empty(fits + 1, 768, device="meta"), ws, [None] * n,
                    device_type="meta")


def test_launch_counter_is_among_the_attention_counters():
    assert (gemm.linear_cuda, "launches") in att._COUNTERS
    before = att.launch_counts()
    i = att._COUNTERS.index((gemm.linear_cuda, "launches"))
    att.add_launches(tuple(int(j == i) for j in range(len(before))))
    assert gemm.linear_cuda.launches == before[i] + 1
    att.add_launches(tuple(-int(j == i) for j in range(len(before))))


def test_autograd_path_gradients_equal_f_linear(monkeypatch):
    """``_Gemm`` over three weights (one without bias) with a plain stand-in
    for the kernel: output and every gradient as ``F.linear``'s."""
    def stand_in(x, ws, bs, gelu=False):
        return tuple(F.linear(x, w, b) for w, b in zip(ws, bs))

    monkeypatch.setattr(gemm, "linear_cuda", stand_in)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 64, generator=g)
    ws = [torch.randn(128, 64, generator=g) for _ in range(3)]
    bs = [torch.randn(128, generator=g), None, torch.randn(128, generator=g)]
    r = [torch.randn(2, 5, 128, generator=g) for _ in range(3)]
    grads = []
    for path in ("op", "plain"):
        leaves = [t.clone().requires_grad_() for t in [x, *ws]
                  + [b for b in bs if b is not None]]
        lx, lw, lb = leaves[0], leaves[1:4], iter(leaves[4:])
        lbs = [next(lb) if b is not None else None for b in bs]
        if path == "op":
            ys = gemm._Gemm.apply(lx, 3, *lw, *lbs)
        else:
            ys = [F.linear(lx, w, b) for w, b in zip(lw, lbs)]
        sum((y * ri).sum() for y, ri in zip(ys, r)).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6)
