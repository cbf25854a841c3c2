#!/usr/bin/env python3
"""Launch every kernel of the PyTorch port's attention library at small
sizes between guard bands, and under ``compute-sanitizer`` where it can
attach, on one CUDA card.

    python3 tools/torch_kernel_sanitize.py [--race] [--count [--report FILE]]
    PYTORCH_NO_CUDA_MEMORY_CACHING=1 compute-sanitizer --tool memcheck \\
        --error-exitcode 1 python3 tools/torch_kernel_sanitize.py
    compute-sanitizer --tool racecheck --error-exitcode 1 \\
        python3 tools/torch_kernel_sanitize.py --race

The library (``ruart_tpu_torch/csrc/attention.cu``, ``attention_bf16.cu``
and ``gemm_tf32x3.cu``, built by ``ops.attention.build_kernel``) holds one
kernel per template instance. The sweep (:func:`cases`) launches each at
least once through its wrapper:

* K1/K2 (``attention_rows_cuda``) in fp32 and bf16 at head widths 8, 24,
  40, 64, 72 and 104 (every padded width either source's dispatch picks:
  16 to 128 in steps of the bf16 kernel's 16, the fp32 kernel's 32), both
  bias forms, L 1, 16, 31, 32, 33, 64, 65 and 512;
* one launch per dtype whose rows x query tiles pass 65,535 (the grid's
  y/z split): dh 16, L 16, 70,000 rows of one head;
* q/k/v and the bias one element off 16-byte alignment (the element-wise
  and 4-byte staging paths);
* K3 (``flash_attention_cuda``) in fp32 and bf16 at D 8, 40, 72 and 104,
  once through head-major strides of a model-layout tensor;
* ``sharded_fused_attention`` on a tp-2 shard of 6 heads;
* G1 (``ops.gemm.linear_cuda``, ``csrc/gemm_tf32x3.cu``) with one to three
  weights, with and without bias and gelu, M off its tiles (1, 130, 200)
  and K of one stage (32) to six;
* the Moonlight encoder's kernels: the bf16 attention at 192-wide
  query/key and 128-wide value heads (``attention_rows_cuda(...,
  scale=)``) at every length above, both bias forms; ``csrc/moe_bf16.cu``
  (``ops.moe``: route, permute, the grouped gate/up and down products,
  combine) at :data:`MOE_CASES`, rows off the 64-row tiles, experts with
  no rows.

Every input is a copy between two GUARD_BYTES bands of NaN, so a read past
either end that reaches an output makes it NaN; every output (but the
sharded call's, which allocates its own) lies between two bands of
SENTINEL bytes that must stay as they were, and starts as NaN, so an
element the kernel does not write shows. Each launch is held to its plain
PyTorch version on the clean inputs (1e-5 in fp32, 2e-2 in bf16).

Under ``compute-sanitizer`` the sweep also meets memcheck (without the
caching allocator, ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, each tensor is an
allocation of its own); ``--race`` launches K1 in fp32 and bf16 at
``chip_smoke.py``'s two RACE_SHAPES only, for racecheck and synccheck.
``--count`` runs the sweep under ``torch.profiler`` (no sanitizer),
counts the distinct kernel names it launched and fails unless every
kernel of the library is among them; the library's list comes from
nvcc's ``-Xptxas -v`` report (``--report FILE``, else a fresh build).
Prints one JSON line last; exits 1 on a disagreement, a guard band
written or a kernel not launched, 2 without a card.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

HEAD_WIDTHS = (8, 24, 40, 64, 72, 104)
LENGTHS = (1, 16, 31, 32, 33, 64, 65, 512)
Z_SPLIT_ROWS = 70_000      # one head of dh 16 at L 16: one query tile a row
FLASH_WIDTHS = (8, 40, 72, 104)
# G1 (M, N, K, weights, gelu, bias)
GEMM_CASES = ((130, 256, 128, 3, True, True), (1, 128, 64, 1, False, False),
              (200, 384, 192, 2, False, True), (130, 128, 32, 1, True, True))
# the expert layer (tokens, hidden, expert width, experts, top k)
MOE_CASES = ((37, 128, 64, 8, 2), (130, 64, 128, 5, 3))
MOE_OPS = ("moe_route", "moe_permute", "moe_gemm", "moe_combine")
# rows, L, heads, dh, segment bias: chip_smoke.RACE_SHAPES
RACE_SHAPES = ((136, 32, 12, 64, True), (8, 512, 12, 64, True))


def cases(race: bool = False):
    """The launches of the sweep, as dicts: ``op`` ("rows", "flash" or
    "sharded"), ``dtype`` ("float32" or "bfloat16"), the shape, the bias
    form and ``unaligned`` / ``strided``."""
    out = []

    def rows(dtype, B, L, H, dh, bias_2d, unaligned=False):
        out.append(dict(op="rows", dtype=dtype, B=B, L=L, H=H, dh=dh,
                        bias_2d=bias_2d, unaligned=unaligned))

    if race:
        for B, L, H, dh, bias_2d in RACE_SHAPES:
            for dtype in ("float32", "bfloat16"):
                rows(dtype, B, L, H, dh, bias_2d)
        return out
    for dtype in ("float32", "bfloat16"):
        for dh in HEAD_WIDTHS:
            for L in LENGTHS:
                for bias_2d in (True, False):
                    rows(dtype, 1 if L == 512 else 3, L, 2, dh, bias_2d)
        rows(dtype, Z_SPLIT_ROWS, 16, 1, 16, False)
        for L in (32, 65):
            for bias_2d in (True, False):
                rows(dtype, 3, L, 2, 64, bias_2d, unaligned=True)
        for D in FLASH_WIDTHS:
            out.append(dict(op="flash", dtype=dtype, B=2, H=3, L=33, D=D,
                            strided=False))
        out.append(dict(op="flash", dtype=dtype, B=2, H=3, L=65, D=64,
                        strided=True))
    out.append(dict(op="sharded", dtype="float32", B=8, L=32, H=12, dh=64,
                    bias_2d=True, unaligned=False))
    for M, N, K, n, gelu, bias in GEMM_CASES:
        out.append(dict(op="gemm", dtype="float32", M=M, N=N, K=K, n=n,
                        gelu=gelu, bias=bias))
    for L in LENGTHS:
        for bias_2d in (True, False):
            out.append(dict(op="wide", dtype="bfloat16", B=1 if L == 512 else 3,
                            L=L, H=2, dh=192, dv=128, bias_2d=bias_2d))
    for T, D, W, E, k in MOE_CASES:
        for op in MOE_OPS:
            for gate_up in ((True, False) if op == "moe_gemm" else (True,)):
                out.append(dict(op=op, dtype="bfloat16", T=T, D=D, W=W, E=E,
                                k=k, gate_up=gate_up))
    return out


def kernel_of(case) -> str:
    """The template instance a case launches, named as :func:`normalize`
    names it: the dispatch of ``attention.cu`` (fp32 K1/K2, K3: dh padded to
    a multiple of 32) and ``attention_bf16.cu`` (bf16 K1/K2: dh padded to
    16, 32, 48, 64, 96 or 128; one key tile up to L 32)."""
    if case["op"] == "gemm":
        return "gemm_tf32x3_kernel"
    if case["op"] == "moe_gemm":
        return f"moe_gemm_kernel<{'true' if case['gate_up'] else 'false'}>"
    if case["op"] in MOE_OPS:
        return case["op"] + "_kernel"
    if case["op"] == "wide":
        bias = "true" if case["bias_2d"] else "false"
        one = "true" if case["L"] <= 32 else "false"
        return f"attention_bf16_kernel<192,128,{bias},{one}>"
    if case["op"] == "flash":
        dp = -(-case["D"] // 32) * 32
        t = "float" if case["dtype"] == "float32" else "__nv_bfloat16"
        return f"attention_kernel<{t},{dp},false>"
    dh = case["dh"] // 2 if case["op"] == "sharded" else case["dh"]
    bias = "true" if case["bias_2d"] else "false"
    if case["dtype"] == "float32":
        return f"attention_kernel<float,{-(-dh // 32) * 32},{bias}>"
    dp = next(w for w in (16, 32, 48, 64, 96, 128) if dh <= w)
    one = "true" if case["L"] <= 32 else "false"
    return f"attention_bf16_kernel<{dp},{dp},{bias},{one}>"


def normalize(name: str) -> str:
    """A kernel's name as the profiler or c++filt gives it, without its
    return type, namespace, parameters and spaces."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[len("void "):]
    return name.replace(" ", "")


def library_kernels(report: str):
    """The kernels nvcc compiled, from its ``-Xptxas -v`` report,
    demangled by c++filt and normalized."""
    mangled = [line.split("'")[1] for line in report.splitlines()
               if "Compiling entry function" in line]
    shown = subprocess.run(["c++filt"], input="\n".join(mangled),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return sorted({normalize(n) for n in shown})


GUARD_BYTES = 4096        # guard band on each side of every tensor
SENTINEL = 0x5A           # an output guard's bytes


def guarded(x, shift: int = 0):
    """A copy of ``x`` in the middle of a buffer whose GUARD_BYTES on either
    side are NaN (-1 for an integer tensor: no expert, row or offset),
    ``shift`` elements past a 16-byte boundary: a read past either end of
    the copy that reaches an output makes it NaN (or out of range)."""
    g = GUARD_BYTES // x.element_size()
    fill = float("nan") if x.is_floating_point() else -1
    buf = torch.full((x.numel() + 2 * g + shift,), fill,
                     dtype=x.dtype, device=x.device)
    out = buf[g + shift:g + shift + x.numel()].view(x.shape)
    out.copy_(x)
    return out


class GuardedOut:
    """An output tensor between two guard bands of SENTINEL bytes, NaN
    inside until the kernel writes it."""

    def __init__(self, shape, dtype, device="cuda"):
        n = math.prod(shape)
        self.g = GUARD_BYTES // torch.empty((), dtype=dtype).element_size()
        self.buf = torch.full((n + 2 * self.g,), float("nan"), dtype=dtype,
                              device=device)
        raw = self.buf.view(torch.uint8)
        raw[:GUARD_BYTES] = SENTINEL
        raw[-GUARD_BYTES:] = SENTINEL
        self.tensor = self.buf[self.g:self.g + n].view(shape)

    def guards_intact(self) -> bool:
        raw = self.buf.view(torch.uint8)
        return bool((raw[:GUARD_BYTES] == SENTINEL).all()
                    and (raw[-GUARD_BYTES:] == SENTINEL).all())


def launch(att, case, seed):
    """Run one case on the card from guarded inputs into a guarded output,
    and its plain version on the same values; returns (max |kernel -
    plain|, tolerance, output guards intact)."""
    import chip_smoke as cs

    dtype = getattr(torch, case["dtype"])
    tol = cs.TOL[case["dtype"]]
    if case["op"] in MOE_OPS:
        return launch_moe(case, seed)
    if case["op"] == "wide":
        B, L, H = case["B"], case["L"], case["H"]
        q, k, _, bias = cs.make_inputs(B, L, H, case["dh"], dtype,
                                       case["bias_2d"], seed)
        v = cs.make_inputs(B, L, H, case["dv"], dtype, case["bias_2d"],
                           seed + 1)[2]
        scale = case["dh"] ** -0.5
        want = att.attention_rows_plain(q, k, v, bias, H, scale=scale)
        out = GuardedOut(want.shape, dtype)
        got = att.attention_rows_cuda(*(guarded(x) for x in (q, k, v, bias)),
                                      H, out=out.tensor, scale=scale)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        return err, tol, out.guards_intact()
    if case["op"] == "gemm":
        from ruart_tpu_torch.ops import gemm

        M, N, K, n = case["M"], case["N"], case["K"], case["n"]
        x, ws, bs = cs.gemm_inputs(M, N, K, n, case["bias"], seed)
        want = [gemm.linear_plain(x, w, b, case["gelu"])
                for w, b in zip(ws, bs)]
        outs = [GuardedOut((M, N), torch.float32) for _ in range(n)]
        gemm.linear_cuda(guarded(x), [guarded(w) for w in ws],
                         [None if b is None else guarded(b) for b in bs],
                         case["gelu"], outs=[o.tensor for o in outs])
        torch.cuda.synchronize()
        err = max((o.tensor - w).abs().max().item()
                  for o, w in zip(outs, want))
        return err, tol, all(o.guards_intact() for o in outs)
    if case["op"] == "flash":
        B, H, L, D = case["B"], case["H"], case["L"], case["D"]
        q, k, v, bias = cs.flash_inputs(B, H, L, D, dtype, seed)
        want = att.flash_attention_plain(q, k, v, bias)
        if case["strided"]:  # head-major views of model-layout tensors
            q, k, v = (guarded(x.transpose(1, 2).contiguous()).transpose(1, 2)
                       for x in (q, k, v))
        else:
            q, k, v = (guarded(x) for x in (q, k, v))
        out = GuardedOut(want.shape, torch.float32)
        got = att.flash_attention_cuda(q, k, v, guarded(bias), out=out.tensor)
    else:
        B, L, H, dh = case["B"], case["L"], case["H"], case["dh"]
        q, k, v, bias = cs.make_inputs(B, L, H, dh, dtype, case["bias_2d"],
                                       seed, pad_rows=dh in (16, 64))
        shift = int(case["unaligned"])
        if case["op"] == "sharded":
            from ruart_tpu_torch.parallel.mesh import Mesh

            cols = slice(0, H * dh // 2)  # tp shard 0 of 2: heads 0-5
            q, k, v = (x[:, :, cols].contiguous() for x in (q, k, v))
            want = att.attention_rows_plain(q, k, v, bias, H // 2)
            out = None  # the sharded call allocates its own output
            got = att.sharded_fused_attention(
                *(guarded(x) for x in (q, k, v, bias)), H,
                Mesh.local(1, 2, 0, 0))
        else:
            want = att.attention_rows_plain(q, k, v, bias, H)
            out = GuardedOut(want.shape, dtype)
            got = att.attention_rows_cuda(
                *(guarded(x, shift) for x in (q, k, v, bias)), H,
                out=out.tensor)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    return err, tol, out is None or out.guards_intact()


def launch_moe(case, seed):
    """One of the expert layer's kernels from guarded inputs (the grouped
    product also into a guarded output) against its plain twin on the
    same values: (error over the output's scale, 1e-2, guards intact)."""
    import chip_smoke as cs
    from ruart_tpu_torch.ops import moe

    T, D, W, E, k = (case[n] for n in ("T", "D", "W", "E", "k"))
    x, logits, bias, wgu, wd, shared, res = cs.moe_inputs(T, D, W, E, k,
                                                          seed, True)
    idx, w, counts = moe.route_plain(logits, bias, k, 2.446)
    offsets, rows, slot_pos = moe.permute_plain(idx, counts)
    h = moe.grouped_gemm_plain(x, rows, wgu, offsets, True)
    y = moe.grouped_gemm_plain(h, None, wd, offsets, False)
    op, intact = case["op"], True
    if op == "moe_route":
        got = moe.route_cuda(guarded(logits), guarded(bias), k, 2.446)
        same = torch.equal(got[0].sort(-1).values, idx.sort(-1).values)
        err = 0.0 if same and torch.equal(got[2], counts) else 1.0
        return err, 1e-2, intact
    if op == "moe_permute":
        off, r, sp = moe.permute_cuda(guarded(idx), guarded(counts))
        ok = torch.equal(off, offsets) and torch.equal(
            r[sp.long()].long(),
            torch.arange(T, device="cuda").repeat_interleave(k))
        return (0.0 if ok else 1.0), 1e-2, intact
    if op == "moe_gemm":
        gate_up = case["gate_up"]
        a, wt, want = (x, wgu, h) if gate_up else (h, wd, y)
        out = GuardedOut(want.shape, torch.bfloat16)
        moe.grouped_gemm_cuda(guarded(a), guarded(rows) if gate_up else None,
                              guarded(wt), guarded(offsets), gate_up,
                              out=out.tensor)
        got, intact = out.tensor, out.guards_intact()
    else:
        want = moe.combine_plain(y, slot_pos, w, shared, res)
        got = moe.combine_cuda(guarded(y), guarded(slot_pos), guarded(w),
                               guarded(shared), guarded(res))
    torch.cuda.synchronize()
    scale = want.float().abs().max().clamp(min=1e-30)
    err = float((got.float() - want.float()).abs().max() / scale)
    return err, 1e-2, intact and out_ok(got)


def out_ok(t) -> bool:
    return bool(torch.isfinite(t.float()).all())


def sweep(att, race: bool):
    """Every case once; returns (launches, worst error over tolerance,
    the cases that disagreed)."""
    worst, bad = 0.0, []
    todo = cases(race)
    for i, case in enumerate(todo):
        err, tol, intact = launch(att, case, i)
        worst = max(worst, err / tol)
        if not (err <= tol and intact):
            bad.append(dict(case, err=err, guards_intact=intact))
    return len(todo), worst, bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--race", action="store_true",
                        help="K1 at the two RACE_SHAPES only")
    parser.add_argument("--count", action="store_true",
                        help="count the kernels launched under the profiler")
    parser.add_argument("--report", default="",
                        help="nvcc's -Xptxas -v report of the library")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ruart_tpu_torch.ops import attention as att

    result = {"mode": "race" if args.race else "sweep"}
    if args.count:
        from torch.profiler import ProfilerActivity, profile

        if args.report:
            with open(args.report) as f:
                report = f.read()
        else:
            report = att.build_kernel(force=True)
        library = library_kernels(report)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n, worst, bad = sweep(att, args.race)
        launched = {normalize(e.key) for e in prof.key_averages()}
        missing = [k for k in library if k not in launched]
        result.update(library=len(library), covered=len(library) - len(missing),
                      missing=missing)
    else:
        n, worst, bad = sweep(att, args.race)
        missing = []
    result.update(launches=n, worst_err_over_tol=worst, disagree=bad)
    print(json.dumps(result), flush=True)
    return 1 if bad or missing else 0


if __name__ == "__main__":
    sys.exit(main())
