"""The Moonlight encoder's sparse expert layer: routing, permutation by
expert, the grouped expert products and the weighted combine.

``csrc/moe_bf16.cu`` holds the kernels (bf16 on the tensor cores; built
with the attention sources into one library, ``ops.attention.build_kernel``).
They replace no TPU kernel: the JAX package has no expert layer. Each
step has a plain PyTorch twin here, the only path for CPU tensors; CUDA
tensors take the kernel or raise. No step brings the routing to the host,
so a layer that runs inside a CUDA graph needs no synchronisation.

* :func:`route` -- sigmoid scores of the fp32 router logits [T, E], the
  top k of score + correction bias, the weights score / sum * scale; the
  experts' row counts (and, given ``load``, a running int64 count).
* :func:`permute` -- the experts' row offsets [E + 1], each routed row's
  token (``rows``, in expert order) and each (token, slot)'s row
  (``slot_pos``).
* :func:`grouped_gemm` -- per expert e, its rows times its weight:
  ``gate_up`` gathers the token rows and applies silu(gate) * up over the
  stacked [E, 2N, K] weight; else the permuted rows times [E, N, K].
* :func:`combine` -- per token, the fp32 sum of its rows' outputs times
  their weights, rounded to the input's type, plus the shared experts'
  output, plus the residual.
* :func:`experts` -- the four in order: the routed part of the layer.

Launch counts: ``route_cuda.launches``, ``permute_cuda.launches``,
``grouped_gemm_cuda.launches``, ``combine_cuda.launches`` (registered with
``ops.attention``'s counters, so a graph replay counts its capture's).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ruart_tpu_torch.ops import attention as _att

MAX_EXPERTS = 256
MAX_TOP_K = 16
TILE_N = 64   # N must be a multiple
TILE_K = 32   # K must be a multiple
TILE_M = 64
MAX_ROW_TILES = 65535


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _att._library()
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("ruart_moe_route", [p, p, i, i, i, ctypes.c_float, p, p, p, p, p]),
            ("ruart_moe_permute", [p, i, i, i, p, p, p, p, p, p]),
            ("ruart_moe_gemm", [p, p, p, p, i, i, i, i, i, p, p]),
            ("ruart_moe_combine", [p, p, p, p, p, i, i, i, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# -- plain twins --------------------------------------------------------------


def route_plain(logits: torch.Tensor, bias: torch.Tensor, k: int,
                scale: float, load: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx int32 [T, k], weight fp32 [T, k], counts int32 [E])."""
    scores = torch.sigmoid(logits.float())
    _, idx = torch.topk(scores + bias.float(), k, dim=-1)
    weight = scores.gather(1, idx)
    weight = weight / (weight.sum(-1, keepdim=True) + 1e-20) * scale
    counts = torch.bincount(idx.reshape(-1), minlength=logits.shape[1])
    if load is not None:
        load.add_(counts)
    return idx.int(), weight, counts.int()


def permute_plain(idx: torch.Tensor, counts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(offsets int32 [E + 1], rows int32 [T k], slot_pos int32 [T k]):
    slots sorted by expert, in token order within one."""
    k = idx.shape[1]
    order = torch.argsort(idx.reshape(-1).long(), stable=True)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    slot_pos = torch.empty_like(order)
    slot_pos[order] = torch.arange(order.numel(), device=order.device)
    return offsets.int(), (order // k).int(), slot_pos.int()


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in the inputs' type (each op rounding to it)."""
    return F.silu(gate) * up


def grouped_gemm_plain(a: torch.Tensor, rows: Optional[torch.Tensor],
                       w: torch.Tensor, offsets: torch.Tensor,
                       gate_up: bool) -> torch.Tensor:
    """A loop over the experts: rows [offsets[e], offsets[e+1]) of the
    output are expert e's product (see the module doc)."""
    E = w.shape[0]
    N = w.shape[1] // 2 if gate_up else w.shape[1]
    M = rows.shape[0] if rows is not None else a.shape[0]
    out = a.new_zeros(M, N)
    offs = offsets.tolist()
    for e in range(E):
        lo, hi = offs[e], offs[e + 1]
        if hi == lo:
            continue
        x = (a.index_select(0, rows[lo:hi].long()) if rows is not None
             else a[lo:hi])
        y = F.linear(x, w[e])
        out[lo:hi] = swiglu_plain(y[:, :N], y[:, N:]) if gate_up else y
    return out


def combine_plain(y: torch.Tensor, slot_pos: torch.Tensor,
                  weight: torch.Tensor, shared: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    T, k = weight.shape
    rows = y.index_select(0, slot_pos.reshape(-1).long()).view(T, k, -1)
    out = (rows.float() * weight[..., None]).sum(1).to(y.dtype)
    if shared is not None:
        out = out + shared
    if residual is not None:
        out = residual + out
    return out


# -- kernels ------------------------------------------------------------------


def _on_card(name, *tensors):
    dev = tensors[0].device
    _need(all(t.is_cuda and t.device == dev and t.is_contiguous()
              for t in tensors if t is not None),
          f"{name}: tensors must be contiguous on one CUDA device")


def route_cuda(logits, bias, k, scale, load=None):
    _on_card("route_cuda", logits, bias, load)
    T, E = logits.shape
    _need(logits.dtype == torch.float32 and bias.dtype == torch.bfloat16
          and bias.shape == (E,), "route_cuda: fp32 logits [T, E] and a "
          "bf16 bias [E]")
    _need(0 < E <= MAX_EXPERTS and 0 < k <= min(MAX_TOP_K, E),
          f"route_cuda: {E} experts, top {k}")
    _need(load is None or (load.dtype == torch.int64 and load.shape == (E,)),
          "route_cuda: load must be int64 [E]")
    idx = torch.empty(T, k, dtype=torch.int32, device=logits.device)
    weight = torch.empty(T, k, dtype=torch.float32, device=logits.device)
    counts = torch.zeros(E, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        _raise(_library().ruart_moe_route(
            logits.data_ptr(), bias.data_ptr(), T, E, k, float(scale),
            idx.data_ptr(), weight.data_ptr(), counts.data_ptr(), _ptr(load),
            _stream(logits)), "moe route kernel")
    route_cuda.launches += 1
    return idx, weight, counts


def permute_cuda(idx, counts):
    _on_card("permute_cuda", idx, counts)
    T, k = idx.shape
    E = counts.shape[0]
    _need(idx.dtype == torch.int32 and counts.dtype == torch.int32
          and 0 < E <= MAX_EXPERTS and 0 < k <= MAX_TOP_K,
          "permute_cuda: int32 idx [T, k] and counts [E]")
    dev = idx.device
    cursor = torch.zeros(E, dtype=torch.int32, device=dev)
    offsets = torch.empty(E + 1, dtype=torch.int32, device=dev)
    rows = torch.empty(T * k, dtype=torch.int32, device=dev)
    slot_pos = torch.empty(T * k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _raise(_library().ruart_moe_permute(
            idx.data_ptr(), T, k, E, counts.data_ptr(), cursor.data_ptr(),
            offsets.data_ptr(), rows.data_ptr(), slot_pos.data_ptr(),
            _stream(idx)), "moe permute kernel")
    permute_cuda.launches += 1
    return offsets, rows, slot_pos


def grouped_gemm_cuda(a, rows, w, offsets, gate_up, out=None):
    _on_card("grouped_gemm_cuda", a, rows, w, offsets, out)
    E, Nw, K = w.shape
    N = Nw // 2 if gate_up else Nw
    M = rows.shape[0] if rows is not None else a.shape[0]
    _need(a.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
          and a.dim() == 2 and a.shape[1] == K,
          f"grouped_gemm_cuda: bf16 a [*, {K}] and w [E, N, K]")
    _need(offsets.dtype == torch.int32 and offsets.shape == (E + 1,)
          and (rows is None or rows.dtype == torch.int32),
          "grouped_gemm_cuda: int32 offsets [E + 1] and rows")
    _need(gate_up == (rows is not None),
          "grouped_gemm_cuda: the gate/up product gathers token rows, the "
          "down product reads the permuted rows")
    _need(0 < E <= MAX_EXPERTS and N % TILE_N == 0 and K % TILE_K == 0
          and (not gate_up or Nw % 2 == 0),
          f"grouped_gemm_cuda: N {N} must be a multiple of {TILE_N}, K {K} "
          f"of {TILE_K}, E {E} at most {MAX_EXPERTS}")
    _need(-(-M // TILE_M) + E <= MAX_ROW_TILES,
          f"grouped_gemm_cuda: {M} rows over {E} experts exceed the grid")
    _need(a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
          "grouped_gemm_cuda: a and w must be 16-byte aligned")
    if out is None:
        out = torch.empty(M, N, dtype=torch.bfloat16, device=a.device)
    _need(out.shape == (M, N) and out.dtype == torch.bfloat16,
          f"grouped_gemm_cuda: out must be bf16 [{M}, {N}]")
    with torch.cuda.device(a.device):
        _raise(_library().ruart_moe_gemm(
            a.data_ptr(), _ptr(rows), w.data_ptr(), offsets.data_ptr(), M, E,
            N, K, int(gate_up), out.data_ptr(), _stream(a)),
            "moe grouped gemm kernel")
    grouped_gemm_cuda.launches += 1
    return out


def combine_cuda(y, slot_pos, weight, shared=None, residual=None):
    _on_card("combine_cuda", y, slot_pos, weight, shared, residual)
    T, k = weight.shape
    D = y.shape[1]
    _need(y.dtype == torch.bfloat16 and weight.dtype == torch.float32
          and slot_pos.dtype == torch.int32 and slot_pos.numel() == T * k
          and 0 < k <= MAX_TOP_K and D % 2 == 0,
          "combine_cuda: bf16 y [T k, D] (D even), fp32 weight [T, k], "
          "int32 slot_pos")
    for t in (shared, residual):
        _need(t is None or (t.dtype == torch.bfloat16 and t.shape == (T, D)),
              f"combine_cuda: shared and residual must be bf16 [{T}, {D}]")
    out = torch.empty(T, D, dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        _raise(_library().ruart_moe_combine(
            y.data_ptr(), slot_pos.data_ptr(), weight.data_ptr(),
            _ptr(shared), _ptr(residual), T, k, D, out.data_ptr(),
            _stream(y)), "moe combine kernel")
    combine_cuda.launches += 1
    return out


for _fn in (route_cuda, permute_cuda, grouped_gemm_cuda, combine_cuda):
    _fn.launches = 0
    _att.register_counter(_fn, "launches")


# -- dispatch -----------------------------------------------------------------


def _cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"moe: no path for device {t.device}")


def route(logits, bias, k, scale, load=None):
    fn = route_cuda if _cuda(logits) else route_plain
    return fn(logits, bias, k, scale, load)


def permute(idx, counts):
    return (permute_cuda if _cuda(idx) else permute_plain)(idx, counts)


def grouped_gemm(a, rows, w, offsets, gate_up):
    fn = grouped_gemm_cuda if _cuda(a) else grouped_gemm_plain
    return fn(a, rows, w, offsets, gate_up)


def combine(y, slot_pos, weight, shared=None, residual=None):
    fn = combine_cuda if _cuda(y) else combine_plain
    return fn(y, slot_pos, weight, shared, residual)


def experts(x: torch.Tensor, logits: torch.Tensor, bias: torch.Tensor,
            k: int, scale: float, w_gate_up: torch.Tensor,
            w_down: torch.Tensor, shared: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            load: Optional[torch.Tensor] = None):
    """The routed part of an expert layer on tokens ``x`` [T, D]:
    (residual + combined routed output + shared, the chosen experts
    [T, k])."""
    idx, weight, counts = route(logits, bias, k, scale, load)
    offsets, rows, slot_pos = permute(idx, counts)
    h = grouped_gemm(x, rows, w_gate_up, offsets, gate_up=True)
    y = grouped_gemm(h, None, w_down, offsets, gate_up=False)
    return combine(y, slot_pos, weight, shared, residual), idx
