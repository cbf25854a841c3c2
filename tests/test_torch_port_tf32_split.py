"""The arithmetic of the port's attention kernel (ruart_tpu_torch/csrc/
attention.cu), emulated in torch on the CPU, against the Pallas kernels of
the JAX package in interpret mode.

The kernel multiplies on the tensor cores in TF32 and keeps fp32 accuracy
with the 3xTF32 split: x = big + small, big = cvt.rna.tf32(x), small =
cvt.rna.tf32(x - big), and a*b ~ small*big + big*small + big*big in fp32.
Its softmax runs online over tiles of KEY_TILE keys. This file emulates
that scheme (TF32 rounding on the float32 bit pattern: add 0x1000 to the
magnitude, then clear the 13 low bits, i.e. round half away from zero) and
holds it to ``grouped_attention`` (``_packed_kernel``) and
``flash_attention`` (``_mha_kernel``) within 1e-5 abs, with inputs drawn
from a seed off any grid (not exact in TF32) and every query keeping a
valid key. The same emulation with one TF32 product per fp32 product must
miss by at least ten times more: a kernel that dropped the split would fail
the card's kernel-vs-plain checks.

With a bf16 output (K1 under ``BF16``) the kernel rounds the normalized
probabilities to bf16 before P V, as ``attention_rows_xla`` casts them to
q's type; with more than one key tile a first pass finds each row's max
and sum. Emulated here on bf16 inputs against ``attention_rows_xla`` in
bf16 (evaluated op by op): at most 0.5% of the outputs may round one
bf16 step apart, where the scheme that keeps P in fp32 (the kernel before
this rounding) differs in at least ten times as many.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import (
    attention_rows_xla,
    flash_attention,
    grouped_attention,
)

torch.set_num_threads(2)
TOL = 1e-5
KEY_TILE = 32  # keys per tile of the kernel's online softmax


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the float32 mantissa to 10 bits, ties away
    from zero, on the bit pattern."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    out = sign | mag
    out = torch.where(out >= 2**31, out - 2**32, out)
    return out.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma3 computes it: small terms first."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def kernel_scheme(q, k, v, bias, matmul):
    """Head-major q, k, v [N, L, dh] and an additive bias [N, L, L]: the
    kernel's fp32 online softmax over key tiles, scores and P V through
    ``matmul``, one division by the row sum at the end."""
    N, L, dh = q.shape
    scale = np.float32(1.0 / np.sqrt(dh))
    m = torch.full((N, L, 1), -torch.inf)
    l = torch.zeros(N, L, 1)
    acc = torch.zeros(N, L, dh)
    for k0 in range(0, L, KEY_TILE):
        kt, vt = k[:, k0:k0 + KEY_TILE], v[:, k0:k0 + KEY_TILE]
        s = matmul(q, kt.transpose(1, 2)) * scale + bias[:, :, k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + matmul(p, vt)
        m = m_new
    return acc / l


def _rows_inputs(seed, B, L, H, dh, segment):
    """Model-layout q, k, v [B, L, H*dh] ~ N(0, 0.25) and a bias: packed
    segments covering every position ([B, L, L]) or key lengths >= 1
    ([B, L]), so every query keeps a valid key."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H * dh).astype(np.float32) * 0.5
               for _ in range(3))
    if segment:
        seg = np.zeros((B, L), np.int64)
        for b in range(B):
            pos, s = 0, 1
            while pos < L:
                n = min(rng.randint(1, 13), L - pos)
                seg[b, pos:pos + n] = s
                pos, s = pos + n, s + 1
        bias = (1.0 - (seg[:, :, None] == seg[:, None, :])) * -10000.0
    else:
        n = rng.randint(1, L + 1, size=B)
        bias = (1.0 - (np.arange(L)[None] < n[:, None])) * -10000.0
    return q, k, v, bias.astype(np.float32)


def _rows_case(seed, B, L, H, dh, segment):
    q, k, v, bias = _rows_inputs(seed, B, L, H, dh, segment)
    want = np.asarray(grouped_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias)), heads=H, group=2,
        interpret=True))

    def head_major(x):
        return torch.from_numpy(x).reshape(B, L, H, dh).transpose(1, 2) \
            .reshape(B * H, L, dh)

    full = np.broadcast_to(bias[:, None] if segment else bias[:, None, None],
                           (B, H, L, L)).reshape(B * H, L, L)
    inputs = [head_major(x) for x in (q, k, v)] + [torch.from_numpy(full.copy())]

    def run(matmul):
        out = kernel_scheme(*inputs, matmul)
        return out.reshape(B, H, L, dh).transpose(1, 2).reshape(B, L, H * dh)

    return want, run


def _flash_case(seed, B, H, L, D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) * 0.5
               for _ in range(3))
    keep = rng.rand(B, L) > 0.2
    keep[:, 0] = True
    bias = ((1.0 - keep) * -10000.0).astype(np.float32)[:, None, None, :]
    want = np.asarray(flash_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias)), interpret=True))
    full = np.broadcast_to(bias, (B, H, L, L)).reshape(B * H, L, L)
    inputs = [torch.from_numpy(x).reshape(B * H, L, D) for x in (q, k, v)]
    inputs.append(torch.from_numpy(full.copy()))

    def run(matmul):
        return kernel_scheme(*inputs, matmul).reshape(B, H, L, D)

    return want, run


CASES = {
    # _packed_kernel: dh 64 packs two heads per 128-lane bundle
    "packed-segment-L32": lambda: _rows_case(1, 3, 32, 4, 64, True),
    # a key bias at L 130: five key tiles, the last with 2 keys
    "packed-key-L130": lambda: _rows_case(2, 2, 130, 2, 64, False),
    # _mha_kernel, head-major with a [B, 1, 1, L] key bias
    "flash-L130": lambda: _flash_case(3, 2, 2, 130, 64),
}


@pytest.fixture(scope="module")
def errors():
    """Max abs error of the 3xTF32 and 1xTF32 emulations per case."""
    out = {}
    for name, make in CASES.items():
        want, run = make()
        out[name] = tuple(
            float(np.abs(run(mm).numpy() - want).max())
            for mm in (matmul_3xtf32, matmul_1xtf32))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_scheme_matches_pallas_interpret(errors, case):
    err3, _ = errors[case]
    assert err3 <= TOL, f"{case}: 3xTF32 scheme off by {err3:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_1xtf32_scheme_is_ten_times_worse(errors, case):
    err3, err1 = errors[case]
    assert err1 >= 10 * err3 and err1 > TOL, (
        f"{case}: 1xTF32 {err1:.3e} vs 3xTF32 {err3:.3e}")


def test_tf32_rounding_on_the_bit_pattern():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2.0 ** -20,
                      -(1.0 + one_ulp / 2), 3.0 + 2.0 ** -12, 0.0])
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 3.0, 0.0])
    assert torch.equal(tf32(x), want)


def test_split_keeps_fp32_accuracy():
    x = torch.from_numpy(np.random.RandomState(4).randn(10000)
                         .astype(np.float32))
    big, small = split(x)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    assert (big - x).abs().max().item() > 1e-4  # TF32 alone keeps ~3 digits


def kernel_scheme_bf16(q, k, v, bias, round_p=True):
    """The kernel's bf16-output scheme on head-major bf16-valued fp32 q, k,
    v [N, L, dh]: products exact in TF32; row max and sum over the key
    tiles first, then each tile's P = exp(s - m) / l, rounded to bf16 when
    ``round_p``, times V; the output rounded to bf16. ``round_p=False``
    keeps P in fp32 and divides at the end."""
    N, L, dh = q.shape
    scale = np.float32(1.0 / np.sqrt(dh))
    tiles = range(0, L, KEY_TILE)
    scores = [q @ k[:, k0:k0 + KEY_TILE].transpose(1, 2) * scale
              + bias[:, :, k0:k0 + KEY_TILE] for k0 in tiles]
    m = torch.full((N, L, 1), -torch.inf)
    l = torch.zeros(N, L, 1)
    for s in scores:
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    acc = torch.zeros(N, L, dh)
    for k0, s in zip(tiles, scores):
        p = torch.exp(s - m)
        if round_p:
            p = (p / l).bfloat16().float()
        acc = acc + p @ v[:, k0:k0 + KEY_TILE]
    return (acc if round_p else acc / l).bfloat16()


@pytest.mark.parametrize("L", [32, 130], ids=["one-tile", "two-passes"])
def test_bf16_probabilities_round_as_attention_rows_xla(L):
    B, H, dh = 3, 4, 64
    q, k, v, bias = _rows_inputs(5, B, L, H, dh, True)
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(attention_rows_xla(q, k, v, jnp.asarray(bias), H),
                      np.float32)

    def head_major(x):
        return torch.from_numpy(np.asarray(x, np.float32)).reshape(
            B, L, H, dh).transpose(1, 2).reshape(B * H, L, dh)

    full = torch.from_numpy(np.broadcast_to(
        bias[:, None], (B, H, L, L)).reshape(B * H, L, L).copy())
    shares = []
    for round_p in (True, False):
        got = kernel_scheme_bf16(*(head_major(x) for x in (q, k, v)), full,
                                 round_p)
        got = got.float().reshape(B, H, L, dh).transpose(1, 2).reshape(
            B, L, H * dh).numpy()
        shares.append(float((got != want).mean()))
    assert shares[0] <= 0.005, shares
    assert shares[1] >= 10 * max(shares[0], 1e-4), shares
