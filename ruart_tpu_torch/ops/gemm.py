"""The BERT encoder's fp32 Linears on Hopper's tensor cores (G1).

``csrc/gemm_tf32x3.cu`` computes Y = X W^T + b with fp32 inputs and
output, its products in 3xTF32 (``wgmma`` on the tensor cores, the split
of ``csrc/attention.cu``: fp32 accuracy at up to 165 TFLOP/s, where
cuBLAS's fp32 SGEMM runs on the CUDA cores' 67). It replaces no TPU
kernel: the JAX package leaves these products to XLA. It is built with
the attention sources into one library (``ops.attention.build_kernel``).

* :func:`linear_plain` -- the plain version (``F.linear``, then the exact
  gelu on request). The only path for CPU tensors.
* :func:`linear_cuda` -- checks its inputs and launches the kernel on the
  current stream: X [..., K] against one to three weights [N, K] of one
  shape (Q, K and V in one launch), each with its bias or none, the erf
  gelu fused on request. Counts its launches in ``linear_cuda.launches``
  (registered with ``ops.attention``'s counters, so a CUDA graph's replay
  counts its capture's launches). A failed build or launch raises.
* :func:`linear_many` / :func:`linear` -- dispatch on the input's device:
  CPU tensors take the plain version, CUDA tensors the kernel, through
  :class:`_Gemm` where autograd needs a graph. No fallback.

The kernel has one tile shape, 128 x 128: every Linear of the port's
encoder has an N that is a multiple of 128 (768, 3072 and the tp 2
shards' 384 and 1536) and M is a packed table's tokens, thousands at the
benchmark's shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ruart_tpu_torch.ops import attention as _att

MAX_WEIGHTS = 3
TILE = 128   # rows and columns of an output tile; N must be a multiple
K_STEP = 32  # K must be a multiple: the depth of a stage
MAX_Y_TILES = 65535  # the grid's y extent: M's tiles of every weight


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 gelu: bool = False) -> torch.Tensor:
    """``F.linear``, then ``F.gelu`` (exact erf form) when ``gelu``."""
    y = F.linear(x, weight, bias)
    return F.gelu(y) if gelu else y


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _att._library()
    fn = lib.ruart_gemm_tf32x3
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _check(x, weights, biases, device_type: str = "cuda"):
    """(M, N, K) of a launch; raises on what the kernel does not take. The
    device comes last (``device_type``: where x must lie), so that a test
    without a card reaches every other rule."""
    if not 1 <= len(weights) <= MAX_WEIGHTS or len(biases) != len(weights):
        raise ValueError(f"gemm: 1 to {MAX_WEIGHTS} weights with one bias "
                         f"(or None) each, got {len(weights)} and "
                         f"{len(biases)}")
    if x.dtype != torch.float32:
        raise ValueError(f"gemm: dtype {x.dtype} not supported (fp32 only)")
    if x.dim() < 1 or not x.is_contiguous() or not _aligned(x):
        raise ValueError("gemm: x must be contiguous and 16-byte aligned")
    K = x.shape[-1]
    N = weights[0].shape[0]
    for w, b in zip(weights, biases):
        if w.dtype != torch.float32 or (b is not None
                                        and b.dtype != torch.float32):
            raise ValueError("gemm: weights and biases must be fp32")
        if tuple(w.shape) != (N, K):
            raise ValueError(f"gemm: weight shape {tuple(w.shape)}, "
                             f"expected {(N, K)}")
        if not w.is_contiguous() or not _aligned(w):
            raise ValueError("gemm: a weight is not contiguous and 16-byte "
                             "aligned")
        if b is not None and (tuple(b.shape) != (N,) or not b.is_contiguous()
                              or b.data_ptr() % 8):
            raise ValueError(f"gemm: bias shape {tuple(b.shape)}, expected "
                             f"a contiguous {(N,)}")
    if K % K_STEP or K <= 0:
        raise ValueError(f"gemm: K {K} is not a positive multiple of "
                         f"{K_STEP}")
    if N % TILE or N <= 0:
        raise ValueError(f"gemm: N {N} is not a positive multiple of {TILE}")
    M = x.numel() // K
    if -(-M // TILE) * len(weights) > MAX_Y_TILES:
        raise ValueError(f"gemm: M {M} exceeds the grid")
    if x.device.type != device_type:
        raise ValueError(f"gemm: x must be a {device_type} tensor, not "
                         f"{x.device}")
    for w, b in zip(weights, biases):
        if w.device != x.device or (b is not None and b.device != x.device):
            raise ValueError(f"gemm: weights and biases must be on "
                             f"{x.device}, as x is")
    return M, N, K


def linear_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[Optional[torch.Tensor]],
                gelu: bool = False,
                outs: Optional[Sequence[torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, ...]:
    """Launch the kernel: ``x`` [..., K] times each of ``weights`` ([N, K],
    one shape) plus its bias (or none), gelu'd when ``gelu``; returns one
    contiguous [..., N] fp32 tensor per weight, new or those of ``outs``."""
    M, N, K = _check(x, weights, biases)
    shape = (*x.shape[:-1], N)
    if outs is None:
        outs = tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                     for _ in weights)
    elif len(outs) != len(weights) or not all(
            tuple(t.shape) == shape and t.dtype == torch.float32
            and t.device == x.device and t.is_contiguous() and _aligned(t)
            for t in outs):
        raise ValueError(f"gemm: outs must be {len(weights)} contiguous, "
                         f"aligned fp32 {shape} on {x.device}")
    outs = tuple(outs)
    if M == 0:
        return outs
    lib = _library()
    n = len(weights)
    ptrs = ctypes.c_void_p * MAX_WEIGHTS
    w = ptrs(*(t.data_ptr() for t in weights))
    b = ptrs(*(0 if t is None else t.data_ptr() for t in biases))
    y = ptrs(*(t.data_ptr() for t in outs))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ruart_gemm_tf32x3(x.data_ptr(), M, K, w, b, y, n, N,
                                    int(gelu), stream)
    if err != 0:
        raise RuntimeError(f"gemm kernel launch failed: error {err}")
    linear_cuda.launches += 1
    return outs


linear_cuda.launches = 0
_att.register_counter(linear_cuda, "launches")


class _Gemm(torch.autograd.Function):
    """Forward: :func:`linear_cuda` over x and n weights (and biases).
    Backward: the plain products, dX = sum_i dY_i W_i, dW_i = dY_i^T X,
    db_i = sum of dY_i over the rows, as K1's backward recomputes through
    its plain version."""

    @staticmethod
    def forward(ctx, x, n, *params):
        weights, biases = params[:n], params[n:]
        ctx.save_for_backward(x, *weights)
        ctx.n = n
        ctx.has_bias = [b is not None for b in biases]
        return linear_cuda(x, weights, biases)

    @staticmethod
    def backward(ctx, *grads):
        x, *weights = ctx.saved_tensors
        n = ctx.n
        K = x.shape[-1]
        x2 = x.reshape(-1, K)
        want_x = ctx.needs_input_grad[0]
        want_w = ctx.needs_input_grad[2:2 + n]
        want_b = ctx.needs_input_grad[2 + n:]
        gx = None
        gw, gb = [], []
        for i, (g, w) in enumerate(zip(grads, weights)):
            g2 = g.reshape(-1, w.shape[0])
            if want_x:
                gx = g2 @ w if gx is None else gx + g2 @ w
            gw.append(g2.t() @ x2 if want_w[i] else None)
            gb.append(g2.sum(0) if ctx.has_bias[i] and want_b[i] else None)
        if gx is not None:
            gx = gx.reshape(x.shape)
        return (gx, None, *gw, *gb)


def linear_many(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[Optional[torch.Tensor]],
                gelu: bool = False) -> Tuple[torch.Tensor, ...]:
    """``x`` times each weight plus its bias (gelu'd when ``gelu``): the
    plain version for CPU tensors, one kernel launch for CUDA tensors
    (under autograd through :class:`_Gemm`, the gelu outside it)."""
    if x.device.type == "cpu":
        return tuple(linear_plain(x, w, b, gelu)
                     for w, b in zip(weights, biases))
    if x.device.type != "cuda":
        raise ValueError(f"gemm: no path for device {x.device}")
    tensors = (x, *weights, *(b for b in biases if b is not None))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        outs = _Gemm.apply(x, len(weights), *weights, *biases)
        if not isinstance(outs, tuple):
            outs = (outs,)
        return tuple(F.gelu(y) for y in outs) if gelu else outs
    return linear_cuda(x, weights, biases, gelu)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           gelu: bool = False) -> torch.Tensor:
    """:func:`linear_many` over one weight."""
    return linear_many(x, (weight,), (bias,), gelu)[0]
