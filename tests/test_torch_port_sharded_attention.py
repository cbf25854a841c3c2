"""``ops.attention.sharded_fused_attention`` of the port against the JAX
package's ``sharded_fused_attention`` (the Pallas kernel under
``shard_map``, run with ``interpret=True`` as
``tests/test_pallas_attention.py`` runs it) on CPU meshes (dp, tp) of
(2, 1), (1, 2) and (2, 2): the same seeded q/k/v [4, 16, 4 heads of 64],
with the [B, L] key bias and the [B, L, L] packed segment bias. The port
runs the whole grid in one process (``sharded_fused_attention_global``:
each (d, t) shard sliced out and run on its local heads, as each rank runs
it), through the kernel's dispatch and through the plain version. On the
CPU both are the plain PyTorch attention. Tolerance 1e-5 abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ruart_tpu.ops.attention import sharded_fused_attention as jax_sharded
from ruart_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ruart_tpu_torch.ops.attention import (
    attention_rows_plain,
    sharded_fused_attention,
    sharded_fused_attention_global,
)
from ruart_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(2)
B, L, H, DH = 4, 16, 4, 64
TOL = 1e-5


def _inputs(bias_2d: bool, seed: int = 11):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H * DH)).astype(np.float32)
               for _ in range(3))
    if bias_2d:
        seg = rng.integers(0, 3, (B, L))
        seg[:, 0] = 1
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
        bias = (1.0 - same.astype(np.float32)) * -10000.0
    else:
        mask = (rng.uniform(size=(B, L)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        bias = (1.0 - mask) * -10000.0
    return q, k, v, bias.astype(np.float32)


@pytest.mark.parametrize("bias_2d", [False, True], ids=["key_bias", "segment"])
@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2", "tp2", "dp2tp2"])
def test_sharded_attention_matches_jax(dp, tp, bias_2d):
    q, k, v, bias = _inputs(bias_2d)
    mesh = jax_make_mesh(jax.devices()[:dp * tp], tp=tp)
    want = np.asarray(jax_sharded(*map(jnp.asarray, (q, k, v, bias)), H,
                                  mesh, group=4, interpret=True))
    args = [torch.from_numpy(x) for x in (q, k, v, bias)]
    for plain in (False, True):
        got = sharded_fused_attention_global(*args, H, dp, tp, plain=plain)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the sharded call is K1 over all heads, sliced
    full = attention_rows_plain(*args, H)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL, rtol=0)


def test_rank_call_takes_local_heads_and_refuses_undivided_heads():
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(False))
    mesh = Mesh.local(2, 2, dp_rank=1, tp_rank=1)
    local = [x[2:, :, H * DH // 2:].contiguous() for x in (q, k, v)]
    got = sharded_fused_attention(*local, bias[2:], H, mesh)
    want = attention_rows_plain(q, k, v, bias, H)[2:, :, H * DH // 2:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    with pytest.raises(AssertionError, match="not divisible"):
        sharded_fused_attention(*local, bias[2:], H, Mesh.local(1, 3))
    with pytest.raises(AssertionError, match="not divisible"):
        sharded_fused_attention_global(q, k, v, bias, H, 3, 1)
    with pytest.raises(AssertionError, match="not divisible"):
        sharded_fused_attention_global(q, k, v, bias, H, 1, 3)
