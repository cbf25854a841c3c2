"""The port's attention (ruart_tpu_torch/ops/attention.py) against the JAX
package's: the plain PyTorch version vs the Pallas kernels in interpret
mode (K1 ``_packed_kernel`` at dh 64, K2 ``_grouped_kernel`` at dh 48) and
vs ``attention_rows_xla``, in both bias forms, with an all-pad segment row.

q and k lie on a 1/16 grid, so every score is exact in fp32 whatever the
summation order; a query row whose keys are all masked then compares the
same rounding of ``score - 10000`` in both packages. Tolerance 1e-5 abs
(fp32 softmax and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import attention_rows_xla, grouped_attention
from ruart_tpu_torch.ops import attention as port

torch.set_num_threads(2)
TOL = 1e-5


def _inputs(seed, B, L, H, dh, segment):
    rng = np.random.RandomState(seed)
    D = H * dh
    q, k = (np.round(rng.randn(B, L, D) * 8) / 16 for _ in range(2))
    v = rng.randn(B, L, D) * 0.5
    if segment:
        seg = np.zeros((B, L), np.int64)
        for b in range(1, B):  # row 0 stays all pad
            fill, pos, s = rng.randint(L // 2, L + 1), 0, 1
            while pos < fill:
                n = min(rng.randint(1, 6), fill - pos)
                seg[b, pos:pos + n] = s
                pos, s = pos + n, s + 1
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
        bias = (1.0 - same) * -10000.0
    else:
        n = rng.randint(1, L + 1, size=B)
        bias = (1.0 - (np.arange(L)[None] < n[:, None])) * -10000.0
    return tuple(x.astype(np.float32) for x in (q, k, v, bias))


def _port(fn, arrays, H):
    return fn(*(torch.from_numpy(a) for a in arrays), H).numpy()


CASES = [
    # (B, L, H, dh): K1 bundles 128 lanes at dh 64; dh 48 takes K2
    pytest.param(5, 16, 4, 64, id="K1-dh64"),
    pytest.param(3, 12, 2, 48, id="K2-dh48"),
]


@pytest.mark.parametrize("segment", [True, False], ids=["segment", "key"])
@pytest.mark.parametrize("B,L,H,dh", CASES)
def test_plain_matches_pallas_interpret(B, L, H, dh, segment):
    arrays = _inputs(B * L + dh, B, L, H, dh, segment)
    want = grouped_attention(
        *(jnp.asarray(a) for a in arrays), heads=H, group=2, interpret=True
    )
    got = _port(port.attention_rows_plain, arrays, H)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("segment", [True, False], ids=["segment", "key"])
def test_plain_matches_attention_rows_xla(segment):
    arrays = _inputs(11, 4, 20, 3, 32, segment)
    want = attention_rows_xla(*(jnp.asarray(a) for a in arrays), heads=3)
    got = _port(port.attention_rows_plain, arrays, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_all_pad_row_is_the_uniform_average():
    """A query whose keys are all masked averages v over all L keys (the
    finite -10000 bias is added, never skipped)."""
    q, k, v, bias = _inputs(3, 2, 8, 2, 16, segment=True)
    out = _port(port.attention_rows_plain, (q, k, v, bias), 2)
    assert np.isfinite(out).all()
    # row 0 is all pad: every query there sees scores - 10000 alone
    scores = np.einsum("lhd,mhd->hlm", q[0].reshape(8, 2, 16),
                       k[0].reshape(8, 2, 16)) / 4.0 - 10000.0
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("hlm,mhd->lhd", p, v[0].reshape(8, 2, 16)).reshape(8, 32)
    np.testing.assert_allclose(out[0], want, atol=TOL, rtol=0)


def test_bf16_plain_matches_xla():
    q, k, v, bias = _inputs(5, 3, 16, 4, 64, segment=True)
    want = attention_rows_xla(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(bias),
        heads=4,
    )
    got = port.attention_rows_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(bias), 4,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=2e-2, rtol=0,
    )


def test_dispatch_cpu_takes_the_plain_version():
    arrays = _inputs(2, 2, 8, 2, 16, segment=False)
    np.testing.assert_array_equal(
        _port(port.attention_rows, arrays, 2),
        _port(port.attention_rows_plain, arrays, 2),
    )


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel path never falls back: CPU tensors are refused before
    any build or launch, and the launch count stays put."""
    arrays = _inputs(2, 2, 8, 2, 16, segment=False)
    before = port.attention_rows_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        _port(port.attention_rows_cuda, arrays, 2)
    assert port.attention_rows_cuda.launches == before
