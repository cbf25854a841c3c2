"""The arithmetic of the port's bf16 attention kernel
(ruart_tpu_torch/csrc/attention_bf16.cu), emulated in torch on the CPU,
against the port's plain version and the JAX package's Pallas kernel.

The kernel multiplies bf16 operands on the tensor cores
(``mma.sync.m16n8k16``): every product is exact, and each k-step of 16 adds
its sum to an fp32 accumulator. A head width that is not a multiple of 16
is zero-padded to one in the k dimension. Rows up to L 32 take one key
tile of L rounded up to 16, longer ones tiles of 64 keys; with more than
one tile a first pass finds each query row's max and sum, and the second
rounds the
normalized probabilities P = exp(s - max) / sum to bf16 before P V, which
again sums in k-steps of 16 keys. The output is rounded to bf16. The
kernel divides by the row sum through its reciprocal and one FMA
correction (``quotient``), which rounds as the division does.

Tolerances, at small sizes with inputs drawn from a seed:

* against ``attention_rows_plain`` in bf16 (the kernel's plain version,
  which casts P to q's type as ``attention_rows_xla`` does): at most 0.5%
  of the outputs differ, and none by more than 2e-2 (the card's bf16
  tolerance in chip_smoke.py; one bf16 step of an output below 2 is
  2**-7);
* against ``grouped_attention(packed=True, interpret=True)`` in bf16: within
  2e-2 abs. In interpret mode its dots run in fp32 and keep P in fp32 (the
  TPU's matrix unit rounds P to bf16 at default precision): a difference of
  one output step is expected there.

The same scheme with P kept in fp32 -- the fault a bf16 output once had in
the fp32 kernel -- must fail the first tolerance: at least ten times as
many outputs differ from the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import grouped_attention
from ruart_tpu_torch.ops import attention as port

torch.set_num_threads(2)
TOL = 2e-2        # abs, as chip_smoke.TOL["bfloat16"]
MAX_SHARE = 0.005  # of outputs one bf16 step away from the plain version
SHORT_LEN = 32  # up to here one key tile
KEY_TILE = 64   # keys per tile beyond SHORT_LEN


def _acc_ksteps(a, b):
    """a @ b over the last axis of a in k-steps of 16: each step's products
    summed exactly (float64) and rounded once into the fp32 accumulator."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 16):
        step = a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16, :].double()
        acc = acc + step.float()
    return acc


def _fma(a, b, c):
    """fmaf on float32 tensors: the exact a * b + c, rounded once (float64
    holds the product of two floats exactly)."""
    return (a.double() * b.double() + c.double()).float()


def quotient(e, l):
    """e / l as the kernel's ``quotient``: q = e * (1 / l), corrected by the
    residual e - q l."""
    r = 1.0 / l
    q = e * r
    return _fma(_fma(-q, l, e), r, q)


def kernel_scheme(q, k, v, bias, round_p=True):
    """Head-major bf16 q, k, v [N, L, dh] and an fp32 bias [N, L, L]: the
    kernel's bf16 output (see the module doc). ``round_p=False`` keeps the
    normalized P in fp32."""
    N, L, dh = q.shape
    dp = -(-dh // 16) * 16
    q, k, v = (torch.nn.functional.pad(x.float(), (0, dp - dh))
               for x in (q, k, v))
    scale = np.float32(1.0 / np.sqrt(dh))
    ktile = KEY_TILE if L > SHORT_LEN else -(-L // 16) * 16
    scores = []
    for k0 in range(0, L, ktile):
        s = _acc_ksteps(q, k[:, k0:k0 + ktile].transpose(1, 2))
        # s * scale + bias is one fused multiply-add in the kernel
        scores.append((s.double() * float(scale)
                       + bias[:, :, k0:k0 + ktile].double()).float())
    m = torch.full((N, L, 1), -torch.inf)
    l = torch.zeros(N, L, 1)
    for s in scores:  # pass 1 (the only pass with one tile)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    acc = torch.zeros(N, L, dp)
    for k0, s in zip(range(0, L, ktile), scores):
        p = quotient(torch.exp(s - m), l.expand_as(s))
        if round_p:
            p = p.bfloat16().float()
        acc = acc + _acc_ksteps(p, v[:, k0:k0 + ktile])
    return acc[..., :dh].bfloat16()


def _inputs(seed, B, L, H, dh, segment, pad_rows):
    """q, k ~ N(0, 0.25) on a 1/16 grid (every score exact in fp32), v ~
    N(0, 0.25), all as bf16 values; a segment bias of random packed segments
    (with an all-pad row 0 and pad tails when ``pad_rows``, else covering
    every position) or a key bias of random lengths >= 1."""
    rng = np.random.RandomState(seed)
    q, k = (np.round(rng.randn(B, L, H * dh) * 8) / 16 for _ in range(2))
    v = rng.randn(B, L, H * dh) * 0.5
    if segment:
        seg = np.zeros((B, L), np.int64)
        for b in range(1 if pad_rows else 0, B):
            fill = rng.randint(L // 2, L + 1) if pad_rows else L
            pos, s = 0, 1
            while pos < fill:
                n = min(rng.randint(1, 13), fill - pos)
                seg[b, pos:pos + n] = s
                pos, s = pos + n, s + 1
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
        bias = (1.0 - same) * -10000.0
    else:
        n = rng.randint(1, L + 1, size=B)
        bias = (1.0 - (np.arange(L)[None] < n[:, None])) * -10000.0
    q, k, v = (torch.from_numpy(x.astype(np.float32)).bfloat16()
               for x in (q, k, v))
    return q, k, v, torch.from_numpy(bias.astype(np.float32))


CASES = {
    # (B, L, H, dh, segment, pad_rows): the serving shape's L and dh with
    # an all-pad row; three key tiles in two passes with a key bias; dh 8
    # (one tile of 64 keys) and 24 zero-padded in k; dh 48, which the JAX
    # package sends to _grouped_kernel
    "L32-dh64-segment": (3, 32, 4, 64, True, True),
    "L130-dh64-key": (2, 130, 2, 64, False, False),
    "L50-dh8-segment": (3, 50, 4, 8, True, False),
    "L17-dh24-key": (3, 17, 2, 24, False, False),
    "L32-dh48-segment": (2, 32, 4, 48, True, False),
}


@pytest.fixture(scope="module")
def results():
    """Per case: the plain version, JAX's Pallas kernel in interpret mode,
    and the emulated kernel with P rounded and with P in fp32 ([B, L, D]
    float32 numpy arrays)."""
    out = {}
    for name, (B, L, H, dh, segment, pad_rows) in CASES.items():
        q, k, v, bias = _inputs(len(out), B, L, H, dh, segment, pad_rows)
        plain = port.attention_rows_plain(q, k, v, bias, H)
        pallas = grouped_attention(
            *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(bias.numpy()), heads=H, group=2, packed=True,
            interpret=True)

        def head_major(x):
            return x.reshape(B, L, H, dh).transpose(1, 2).reshape(B * H, L, dh)

        full = (bias[:, None] if segment else bias[:, None, None]).expand(
            B, H, L, L).reshape(B * H, L, L)
        emulated = [
            kernel_scheme(*(head_major(x) for x in (q, k, v)), full, round_p)
            .reshape(B, H, L, dh).transpose(1, 2).reshape(B, L, H * dh)
            for round_p in (True, False)]
        out[name] = [plain.float().numpy(),
                     np.asarray(pallas.astype(jnp.float32))] + [
            e.float().numpy() for e in emulated]
    return out


def _share(a, b):
    return float((a != b).mean())


@pytest.mark.parametrize("case", list(CASES))
def test_scheme_matches_the_plain_version(results, case):
    plain, _, rounded, _ = results[case]
    assert np.abs(rounded - plain).max() <= TOL
    assert _share(rounded, plain) <= MAX_SHARE


@pytest.mark.parametrize("case", list(CASES))
def test_scheme_matches_pallas_interpret(results, case):
    _, pallas, rounded, _ = results[case]
    assert np.abs(rounded - pallas).max() <= TOL


@pytest.mark.parametrize("case", list(CASES))
def test_unrounded_p_fails_the_tolerance(results, case):
    plain, _, rounded, unrounded = results[case]
    share = _share(unrounded, plain)
    assert share > MAX_SHARE and share >= 10 * max(_share(rounded, plain),
                                                   1e-4), share


def test_quotient_rounds_as_the_division():
    """The kernel's reciprocal and FMA correction against fp32 division on a
    million (exp(x), row sum) pairs of a softmax's range; the reciprocal
    alone rounds a quarter of them apart."""
    rng = np.random.RandomState(9)
    e = torch.from_numpy(np.exp(-rng.uniform(0, 30, 10**6)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 512, 10**6).astype(np.float32))
    assert torch.equal(quotient(e, l), e / l)
    assert (e * (1.0 / l) != e / l).float().mean() > 0.1


def test_zero_padding_in_k_is_exact():
    """Zero columns past dh change no score: the scheme at dh 8 equals the
    unpadded products bit for bit (an 8-wide k-step sums exactly too)."""
    q, k, _, _ = _inputs(7, 2, 20, 1, 8, False, False)
    a, b = q[0].float(), k[0].float().T
    padded = _acc_ksteps(torch.nn.functional.pad(a, (0, 8)),
                         torch.nn.functional.pad(b, (0, 0, 0, 8)))
    assert torch.equal(padded, (a.double() @ b.double()).float())
