"""K3 and K1's autograd in the port (ruart_tpu_torch/ops/attention.py)
against the JAX package.

* ``flash_attention_plain`` vs ``ruart_tpu.ops.attention.flash_attention``
  in interpret mode (the Pallas body ``_mha_kernel``) at the shapes of
  tests/test_pallas_attention.py, fp32 and bf16 inputs, fp32 output.
  Tolerance 2e-5 abs (fp32 sums in another order), as that file states.
* ``fused_attention``'s gradient (the port's ``autograd.Function``: kernel
  forward, backward through the plain version) vs the gradient of the JAX
  custom VJP ``fused_attention`` (Pallas forward in interpret mode,
  backward through ``attention_rows_xla``), both bias forms. Tolerance
  1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import flash_attention as jax_flash_attention
from ruart_tpu.ops.attention import fused_attention as jax_fused_attention
from ruart_tpu_torch.ops import attention as port

torch.set_num_threads(2)
FLASH_TOL = 2e-5
GRAD_TOL = 1e-5


def _head_major(seed, B, H, L, D):
    """q/k/v N(0, 1) and a key bias with ~20% masked keys (key 0 kept),
    the inputs tests/test_pallas_attention.py draws, from numpy."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, D).astype(np.float32) for _ in range(3))
    mask = (rng.rand(B, L) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    bias = ((1.0 - mask[:, None, None, :]) * -10000.0).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,L,D", [(3, 2, 16, 8), (2, 4, 50, 64)],
                         ids=["B3-H2-L16-D8", "B2-H4-L50-D64"])
def test_flash_plain_matches_pallas_interpret(B, H, L, D, dtype):
    q, k, v, bias = _head_major(B * L + D, B, H, L, D)
    if dtype == "bfloat16":
        # round the inputs to bf16 once, so both packages read equal values
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                   for x in (q, k, v))
    want = jax_flash_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), jnp.asarray(bias),
        interpret=True,
    )
    got = port.flash_attention_plain(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        torch.from_numpy(bias),
    )
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLASH_TOL,
                               rtol=0)


def test_flash_dispatch_and_refusal():
    q, k, v, bias = (torch.from_numpy(x) for x in _head_major(1, 2, 2, 8, 8))
    torch.testing.assert_close(port.flash_attention(q, k, v, bias),
                               port.flash_attention_plain(q, k, v, bias),
                               rtol=0, atol=0)
    before = port.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        port.flash_attention_cuda(q, k, v, bias)
    assert port.flash_attention_cuda.launches == before


def _model_layout(seed, B, L, H, dh, segment):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, H * dh).astype(np.float32) * 0.5
               for _ in range(3))
    if segment:
        seg = np.zeros((B, L), np.int64)
        for b in range(B):
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
    w = rng.randn(B, L, H * dh).astype(np.float32)
    return q, k, v, bias.astype(np.float32), w


@pytest.mark.parametrize("segment", [True, False], ids=["segment", "key"])
def test_fused_attention_grad_matches_jax_vjp(segment):
    H = 2
    q, k, v, bias, w = _model_layout(7, 3, 12, H, 64, segment)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jax.grad(
        lambda a, b_, c: jnp.sum(
            jax_fused_attention(a, b_, c, jnp.asarray(bias), H, 2, True) * w),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.fused_attention(tq, tk, tv, torch.from_numpy(bias), H)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL,
                                   rtol=0)
