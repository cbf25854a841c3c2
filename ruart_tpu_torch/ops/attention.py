"""Fused multi-head attention: the BERT encoder's kernel and ``flash_attention``.

Port of the TPU kernels of ``ruart_tpu/ops/attention.py``: ``_packed_kernel``
and ``_grouped_kernel`` (reached through ``grouped_attention``) and
``_mha_kernel`` (reached through ``flash_attention``). Two CUDA C++ sources
for sm_90a hold the kernels, by input type:

* ``csrc/attention.cu`` -- K1/K2 on fp32 inputs and K3 (fp32 or bf16
  inputs, fp32 output): products in 3xTF32 on the tensor cores. It reads
  its inputs through element strides, so the model layout and the
  head-major layout take the same code without a copy.
* ``csrc/attention_bf16.cu`` -- K1/K2 on bf16 inputs (the ``BF16``
  encoder): products on the bf16 tensor cores (``mma.sync.m16n8k16``),
  one block per (row, head, query tile). It also takes v narrower than
  q and k, and query/key heads wider than 128: the Moonlight encoder's
  latent attention, 192-wide query/key heads and 128-wide value heads
  (``models/moonlight``), with its scale 1/sqrt(192) passed in.

Each source states what bounds its kernel on an H100 and how its design
answers that. They are compiled with ``nvcc`` at first use, in parallel,
into one library in ``ruart_tpu_torch/_build/`` and loaded with ``ctypes``
(a plain C interface; no PyTorch headers, so the build takes seconds),
together with ``csrc/gemm_tf32x3.cu``, the encoder's fp32 Linears
(``ops/gemm.py``), and ``csrc/moe_bf16.cu``, the Moonlight encoder's
expert layer (``ops/moe.py``).

Model layout (K1/K2): q/k/v are [B, L, H*dh] (v [B, L, H*dv] where it
is narrower; bf16 only); ``bias`` is a float32 [B, L]
additive key bias or a [B, L, L] per-query bias (the packed segment mask).
``scale`` multiplies the scores (1/sqrt(dh) unless given).
The output is [B, L, H*dv] in q's dtype (fp32 or bf16; fp32 scores and
softmax, fp32 sums; in bf16 the normalized probabilities are rounded to
bf16 before P V, as the plain version casts them).

* :func:`attention_rows_plain` — the plain PyTorch version, the
  counterpart of ``attention_rows_xla``. The only path for CPU tensors.
* :func:`attention_rows_cuda` — checks its inputs and launches the kernel
  of their dtype on the current stream; counts its launches in
  ``attention_rows_cuda.launches``, and those on bf16 inputs (the ``BF16``
  encoder, ``attention_bf16.cu``) also in
  ``attention_rows_cuda.bf16_launches``, and those with v narrower than q
  (the latent attention) in ``attention_rows_cuda.wide_launches``. A
  failed build or launch raises.
* :func:`attention_rows` — dispatch on the tensors' device: CPU tensors
  take the plain version, CUDA tensors the kernel. No fallback.
* :func:`fused_attention` — :func:`attention_rows` under autograd, the
  counterpart of the JAX custom VJP: the forward is the kernel, the
  backward recomputes through :func:`attention_rows_plain` (the JAX package
  has no backward kernel either).

On a rank of a (dp, tp) mesh, :func:`sharded_fused_attention` runs the
model-layout kernel on the rank's rows and local heads (the JAX
``shard_map``'s per-shard call); :func:`sharded_fused_attention_global`
runs the whole grid of shards in one process, and :func:`tp_kernel_ok` is
the port's rule for when a tp degree keeps the kernel.

:func:`launch_counts` and :func:`add_launches` read and add to every
launch counter at once; a CUDA graph (``utils/graphs.py``) adds its
capture's launches at each replay, so a replayed forward counts as an
eager one.

Head-major layout (K3): :func:`flash_attention_plain`,
:func:`flash_attention_cuda` (launch count in
``flash_attention_cuda.launches``) and the dispatching
:func:`flash_attention`. q/k/v are [B, H, L, D] in fp32 or bf16, ``bias``
is [B, 1, 1, L]; the output is [B, H, L, D] float32 whatever the input
dtype, with fp32 probabilities, as ``_mha_kernel`` computes it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "attention.cu", _PKG / "csrc" / "attention_bf16.cu",
           _PKG / "csrc" / "gemm_tf32x3.cu", _PKG / "csrc" / "moe_bf16.cu")
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libruart_attention.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the GEMM builds its TMA descriptors with libcuda's cuTensorMapEncodeTiled
LINK_FLAGS = ("-lcuda",)
MAX_LEN = 512
MAX_HEAD_DIM = 128
# the bf16 kernel's query/key heads beside a narrower value head (v up to
# MAX_HEAD_DIM): the latent attention's 192 = 128 + 64 rope dims
MAX_WIDE_HEAD_DIM = 192


def attention_rows_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, scale: float | None = None,
) -> torch.Tensor:
    """Model-layout attention in plain PyTorch (``attention_rows_xla``):
    fp32 scores (times ``scale``, else over sqrt(dh)) and softmax,
    probabilities cast to q's dtype, fp32 sums; v may be narrower than q."""
    B, L, D = q.shape
    dh = D // heads
    dv = v.shape[-1] // heads
    qh = q.reshape(B, L, heads, dh).float()
    kh = k.reshape(B, L, heads, dh).float()
    vh = v.reshape(B, L, heads, dv).float()
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh)
    if scale is None:
        s = s / torch.tensor(float(dh), dtype=torch.float32).sqrt()
    else:
        s = s * scale
    if bias.dim() == 3:
        s = s + bias[:, None].float()
    else:
        s = s + bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    ctx = torch.einsum("bhlm,bmhd->blhd", p, vh)
    return ctx.reshape(B, L, heads * dv).to(q.dtype)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def stale() -> bool:
    """True when :data:`LIBRARY` is missing or older than any of
    :data:`SOURCES`."""
    return not LIBRARY.exists() or LIBRARY.stat().st_mtime < max(
        src.stat().st_mtime for src in SOURCES)


def _run(cmds):
    """Start the commands together; returns (returncode, output) of each."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = []
    for proc in procs:
        out = proc.communicate()[0]
        results.append((proc.returncode, out))
    return results


def build_kernel(force: bool = False) -> str:
    """Compile :data:`SOURCES` for sm_90a, one nvcc per source started
    together, and link them into :data:`LIBRARY` unless it is up to date
    (:func:`stale`). Returns the compiler's report (registers, shared memory
    and spills per kernel from ``-Xptxas -v``), or "" when the existing
    build was kept. Raises RuntimeError, naming the source, when nvcc
    fails."""
    if not force and not stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    temps = []

    def temp(suffix):
        fd, path = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
        os.close(fd)
        temps.append(path)
        return path

    try:
        objects = [temp(".o") for _ in SOURCES]
        compiles = [[_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                     str(src)] for obj, src in zip(objects, SOURCES)]
        library = temp(".so")
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", library, *objects,
                *LINK_FLAGS]
        reports = []
        for cmd, (rc, out) in zip(compiles, _run(compiles)):
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-1]}: "
                                   f"{' '.join(cmd)}\n{out}")
            reports.append(out)
        [(rc, out)] = _run([link])
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) linking {LIBRARY.name}: "
                               f"{' '.join(link)}\n{out}")
        os.replace(library, LIBRARY)
    finally:
        for path in temps:
            if os.path.exists(path):
                os.unlink(path)
    return "".join(reports)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build_kernel()
    lib = ctypes.CDLL(str(LIBRARY))
    fn = lib.ruart_attention_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.ruart_attention_bf16_rows
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.ruart_attention_bf16_rows_v
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.ruart_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ruart_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    fn = lib.ruart_attention_bf16_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, bias, heads):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError("attention_rows_cuda: q, k, v, bias must share one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention_rows_cuda: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention_rows_cuda: q, k, v dtypes differ")
    if bias.dtype != torch.float32:
        raise ValueError(f"attention_rows_cuda: bias must be float32, "
                         f"got {bias.dtype}")
    if (q.dim() != 3 or k.shape != q.shape or v.dim() != 3
            or v.shape[:2] != q.shape[:2]):
        raise ValueError(f"attention_rows_cuda: q/k/v shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, L, D = q.shape
    if heads <= 0 or D % heads or v.shape[2] % heads:
        raise ValueError(f"attention_rows_cuda: widths {D}, {v.shape[2]} not "
                         f"divisible by {heads} heads")
    dh, dv = D // heads, v.shape[2] // heads
    if dv == dh:
        if dh % 8 or dh > MAX_HEAD_DIM:
            raise ValueError(f"attention_rows_cuda: head width {dh} must be "
                             f"a multiple of 8 up to {MAX_HEAD_DIM}")
    elif q.dtype != torch.bfloat16 or not (
            MAX_HEAD_DIM < dh <= MAX_WIDE_HEAD_DIM and dh % 8 == 0
            and 0 < dv <= MAX_HEAD_DIM and dv % 8 == 0):
        raise ValueError(f"attention_rows_cuda: query/key heads of {dh} "
                         f"beside value heads of {dv} take bf16, {dh} over "
                         f"{MAX_HEAD_DIM} up to {MAX_WIDE_HEAD_DIM} and {dv} "
                         f"up to {MAX_HEAD_DIM}, multiples of 8")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"attention_rows_cuda: length {L} not in "
                         f"[1, {MAX_LEN}]")
    if tuple(bias.shape) not in ((B, L), (B, L, L)):
        raise ValueError(f"attention_rows_cuda: bias shape "
                         f"{tuple(bias.shape)} is neither {(B, L)} nor "
                         f"{(B, L, L)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"attention_rows_cuda: {name} is not contiguous")
    return B, L, dh, dv


def _check_out(out, shape, dtype, device, name):
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {dtype} "
                         f"{tuple(shape)} on {device}")
    return out


def attention_rows_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, out: torch.Tensor | None = None, scale: float | None = None,
) -> torch.Tensor:
    """Launch the hand-written kernel on CUDA tensors (see module doc);
    ``out`` (contiguous, v's shape and q's dtype) receives the result
    instead of a new tensor."""
    B, L, dh, dv = _check(q, k, v, bias, heads)
    out = _check_out(out, v.shape, q.dtype, q.device, "attention_rows_cuda")
    if B == 0:
        return out
    lib = _library()
    bf16 = q.dtype == torch.bfloat16
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, L, heads, dh, int(bias.dim() == 3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if dv != dh:
            err = lib.ruart_attention_bf16_rows_v(*args[:9], dv, args[9],
                                                  scale, stream)
        elif bf16:
            err = lib.ruart_attention_bf16_rows(*args, scale, stream)
        else:
            err = lib.ruart_attention_rows(*args, scale, stream)
    if err != 0:
        name = "bf16 attention kernel" if bf16 else "attention kernel"
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    attention_rows_cuda.launches += 1
    if bf16:
        attention_rows_cuda.bf16_launches += 1
    if dv != dh:
        attention_rows_cuda.wide_launches += 1
    return out


attention_rows_cuda.launches = 0
attention_rows_cuda.bf16_launches = 0
attention_rows_cuda.wide_launches = 0


def attention_rows(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, scale: float | None = None,
) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = {} if scale is None else {"scale": scale}
    if q.device.type == "cuda":
        return attention_rows_cuda(q, k, v, bias, heads, **kw)
    if q.device.type == "cpu":
        return attention_rows_plain(q, k, v, bias, heads, **kw)
    raise ValueError(f"attention_rows: no path for device {q.device}")


class _FusedAttention(torch.autograd.Function):
    """Forward: :func:`attention_rows` (the kernel on CUDA tensors).
    Backward: the vector-Jacobian product of :func:`attention_rows_plain`
    at the saved inputs, as ``_fused_attention_bwd`` recomputes through
    ``attention_rows_xla``; bf16 inputs get bf16 gradients, the fp32 bias
    an fp32 one where it needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads, scale=None):
        ctx.save_for_backward(q, k, v, bias)
        ctx.heads, ctx.scale = heads, scale
        if scale is None:
            return attention_rows(q, k, v, bias, heads)
        return attention_rows(q, k, v, bias, heads, scale=scale)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(saved, wanted)]
            out = attention_rows_plain(*inputs, ctx.heads, ctx.scale)
            leaves = [t for t, w in zip(inputs, wanted) if w]
            got = iter(torch.autograd.grad(out, leaves, grad.to(out.dtype)))
        return (*(next(got) if w else None for w in wanted), None, None)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, scale: float | None = None,
) -> torch.Tensor:
    """Differentiable :func:`attention_rows` (see :class:`_FusedAttention`)."""
    return _FusedAttention.apply(q, k, v, bias, heads, scale)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """Head-major attention in plain PyTorch, as ``_mha_kernel`` computes
    it: q/k/v [B, H, L, D] cast to fp32, scores scaled by 1/sqrt(D) plus the
    [B, 1, 1, L] bias, fp32 softmax, fp32 output [B, H, L, D]."""
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.reshape(B, 1, 1, L).float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


def _check_flash(q, k, v, bias):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v, bias must share one "
                         "CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_cuda: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda: q, k, v dtypes differ")
    if bias.dtype != torch.float32:
        raise ValueError(f"flash_attention_cuda: bias must be float32, "
                         f"got {bias.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention_cuda: q/k/v shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, H, L, D = q.shape
    if D % 8 or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head width {D} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"flash_attention_cuda: length {L} not in "
                         f"[1, {MAX_LEN}]")
    if H > 65535:
        raise ValueError(f"flash_attention_cuda: {H} heads exceed 65535")
    if bias.numel() != B * L or bias.shape[-1] != L:
        raise ValueError(f"flash_attention_cuda: bias shape {tuple(bias.shape)}"
                         f" is not {(B, 1, 1, L)}")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(3) != 1:
        raise ValueError("flash_attention_cuda: q, k, v must share strides "
                         "with a contiguous last axis")
    return B, H, L, D


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel on head-major CUDA tensors: q/k/v [B, H, L, D]
    (any batch/head/position strides they share), ``bias`` [B, 1, 1, L];
    returns a contiguous fp32 [B, H, L, D] (``out``, when given)."""
    B, H, L, D = _check_flash(q, k, v, bias)
    out = _check_out(out, q.shape, torch.float32, q.device,
                     "flash_attention_cuda")
    if B == 0 or H == 0:
        return out
    bias = bias.reshape(B, L).contiguous()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ruart_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, L, D, q.stride(0), q.stride(1), q.stride(2),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    raise ValueError(f"flash_attention: no path for device {q.device}")


def tp_kernel_ok(heads: int, dh: int, tp: int) -> bool:
    """True when the kernel can run on ``heads / tp`` local heads per tp
    shard: tp must divide the heads (a shard holds whole heads).

    The JAX package also asks that a shard's head bundle fill the TPU's 128
    lanes (``(heads / tp) % (128 / dh) == 0``) and otherwise sends the layer
    to the einsum path: a TPU layout rule. The Hopper kernel (K1) runs any
    number of heads of any width its build takes (dh a multiple of 8 up to
    128): one block per (row, head) pair, the heads of a row read through
    their column offset, with no packing of heads into lanes. So the port
    keeps the kernel whenever tp divides the heads, where the JAX package
    picks 'xla' (e.g. 4 heads of 8 at tp 2); the scores are the same.
    ``dh`` is kept for the JAX signature."""
    del dh
    return tp <= 1 or heads % tp == 0


def sharded_fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, mesh, plain: bool = False,
) -> torch.Tensor:
    """:func:`fused_attention` on one rank of a (dp, tp) mesh: the
    counterpart of the JAX ``shard_map``'s per-shard ``local``.

    ``q``/``k``/``v`` are this rank's shard [B/dp, L, (H/tp)*dh] (its rows
    of the batch, its tp slice of the head-major features: shard t owns
    heads [t*H/tp, (t+1)*H/tp)); ``bias`` its rows [B/dp, L] or
    [B/dp, L, L]; ``heads`` the GLOBAL head count. Heads are independent,
    so the kernel runs on the local heads with no collective. In the model
    each rank's projections hold only its heads (``BertSelfAttention``), so
    q/k/v arrive contiguous and the kernel reads them without a copy.
    ``plain`` takes :func:`attention_rows_plain` instead (the comparison
    arm). Calls that launch the kernel (CUDA tensors) are counted in
    ``sharded_fused_attention.launches``."""
    tp = mesh.tp
    assert heads % tp == 0, f"heads={heads} not divisible by tp={tp}"
    local_heads = heads // tp
    assert q.shape[2] % local_heads == 0 and bias.shape[0] == q.shape[0], (
        f"local q {tuple(q.shape)} / bias {tuple(bias.shape)} do not hold "
        f"{local_heads} heads of the same rows"
    )
    if plain:
        return attention_rows_plain(q, k, v, bias, local_heads)
    if q.is_cuda:
        sharded_fused_attention.launches += 1
    return fused_attention(q, k, v, bias, local_heads)


sharded_fused_attention.launches = 0


def sharded_fused_attention_global(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    heads: int, dp: int, tp: int, plain: bool = False,
) -> torch.Tensor:
    """The whole (dp, tp) grid of :func:`sharded_fused_attention` in one
    process, on global tensors [B, L, H*dh]: as the JAX function's
    ``shard_map`` slices its operands, each (d, t) shard is sliced out (the
    column slice is copied to make it contiguous, as a rank's projection
    makes it), run, and the results are concatenated. Asserts what the JAX
    function asserts: B % dp == 0, heads % tp == 0 and D % tp == 0."""
    from ruart_tpu_torch.parallel.mesh import Mesh

    B, L, D = q.shape
    assert B % dp == 0, f"batch {B} not divisible by dp={dp}"
    assert heads % tp == 0 and D % tp == 0, (
        f"heads={heads}/D={D} not divisible by tp={tp}"
    )
    rows, cols = B // dp, D // tp
    out = torch.empty_like(q)
    for d in range(dp):
        r = slice(d * rows, (d + 1) * rows)
        for t in range(tp):
            c = slice(t * cols, (t + 1) * cols)
            q_, k_, v_ = (x[r, :, c].contiguous() for x in (q, k, v))
            out[r, :, c] = sharded_fused_attention(
                q_, k_, v_, bias[r].contiguous(), heads,
                Mesh.local(dp, tp, d, t), plain=plain,
            )
    return out


# Every launch counter of the port's kernels: this module's, and those
# other modules add with :func:`register_counter` (``ops.gemm``). A CUDA
# graph launches its kernels at replay, where no wrapper runs:
# ``utils.graphs`` reads the counters around a capture and adds the
# difference back at each replay.
_COUNTERS = [
    (attention_rows_cuda, "launches"),
    (attention_rows_cuda, "bf16_launches"),
    (attention_rows_cuda, "wide_launches"),
    (flash_attention_cuda, "launches"),
    (sharded_fused_attention, "launches"),
]


def register_counter(fn, name: str) -> None:
    """Add the launch counter ``fn.<name>`` to :func:`launch_counts`."""
    if (fn, name) not in _COUNTERS:
        _COUNTERS.append((fn, name))


def launch_counts() -> tuple:
    """The launch counters, in a fixed order (see :func:`add_launches`)."""
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def add_launches(counts) -> None:
    """Add ``counts`` (a :func:`launch_counts` tuple, or a difference of two)
    to the launch counters."""
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)
