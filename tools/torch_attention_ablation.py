#!/usr/bin/env python3
"""Time the PyTorch port's attention kernels against variants of themselves
on one CUDA card (an H100: the kernels are built for sm_90a).

    python3 tools/torch_attention_ablation.py [--parent OLD_attention.cu]
        [--variants NAME ...] [--lengths L ...]
        [--rounds N] [--fp32]

Builds the library of ``ruart_tpu_torch/csrc/attention.cu`` and
``attention_bf16.cu`` as they are and with parts of their work taken out or
changed by text patches (each must apply), plus ``--parent`` (an earlier
``attention.cu``, e.g. from ``git show <commit>:ruart_tpu_torch/csrc/
attention.cu``, whose entry takes bf16 inputs itself: the bf16 path before
``attention_bf16.cu``), with one nvcc per source and variant started
together, into ``ruart_tpu_torch/_build/ablation/``. Inputs are cold in L2
and each call is replayed from a CUDA graph (``chip_smoke.cold_ms``), in
``--rounds`` rounds (2), every other one in reverse order.

The bf16 arm times K1 on bf16 inputs at the serving shape (136 rows x L 32,
12 heads of 64, segment bias), at the chunk shape (4 x L 512, key bias) and
at the serving shape's rows and heads with each of ``--lengths`` (none by
default), for each build. Variants (bf16 kernel):

* ``no_mma`` -- every ``mma.sync`` skipped (the outputs are wrong);
* ``regs80`` -- the one-tile kernels capped at 80 registers instead of 72
  (6 resident blocks of 4 warps by registers instead of 7);
* ``bias_pad`` -- the bias tile padded to ktile + 8 floats a row instead
  of swizzled (18,944 bytes a block at the serving shape instead of
  17,920);
* ``v_waited`` -- with one key tile, V waited for with Q and K instead of
  landing while Q K^T runs;
* ``divide`` -- P as exp(s - max) divided by the row sum, a division per
  element, instead of the reciprocal and its correction (``quotient``);
* ``ktile32`` -- key tiles of 32 instead of 64 beyond L 32 (twice the
  copies and barriers of a pass, half the score registers);
* ``no_overlap`` -- the next key tile's copies are waited for at once, so
  they no longer overlap this tile's products (the double buffer's gain);
* ``warps2`` -- at most 2 warps (32 queries) per block: twice the blocks
  beyond L 32.

``--fp32`` adds the fp32 arm: K1 fp32 at the serving shape and K3 at (16,
12, 128, 64) for ``change`` and ``--parent``.

Prints the card, each build's registers and spills per kernel, and one line
per arm, variant and round with the time, its share of the bound and the
max abs error against the plain version (with, in bf16, the share of
outputs that differ from it).
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "ruart_tpu_torch", "_build", "ablation")
BF16_SOURCE = "attention_bf16.cu"
PATCHES = {  # variant: [(old, new)] applied to attention_bf16.cu
    "no_mma": [('  asm volatile(\n      "mma.sync',
                '  return;\n  asm volatile(\n      "mma.sync')],
    "regs80": [("return one_tile ? (dp <= 64 ? 7",
                "return one_tile ? (dp <= 64 ? 6")],
    "bias_pad": [("  return c ^ ((r & 3) << 3);", "  return c;"),
                 ("  p.bpitch = p.ktile > 32 ? p.ktile : 32;",
                  "  p.bpitch = p.ktile + 8;")],
    "v_waited": [("V may be in flight\n      cp_async_wait<1>();",
                  "V may be in flight\n      cp_async_wait<0>();")],
    "divide": [("  const float q = e * r;\n  return fmaf(fmaf(-q, l, e), r, q);",
                "  return e / l;")],
    "ktile32": [("constexpr int kKeyTile = 64;",
                 "constexpr int kKeyTile = 32;")],
    "no_overlap": [("      issue(it + 1, (it + 1) & 1);\n"
                    "      cp_async_wait<1>();",
                    "      issue(it + 1, (it + 1) & 1);\n"
                    "      cp_async_wait<0>();")],
    "warps2": [("  if (p.warps > kMaxWarps) p.warps = kMaxWarps;\n",
                "  if (p.warps > 2) p.warps = 2;\n")],
}


def patched(text, name):
    """``text`` (attention_bf16.cu) with variant ``name``'s patches; each
    must match exactly once."""
    for old, new in PATCHES[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: patch does not apply: {old!r}")
        text = text.replace(old, new)
    return text


def compile_all(builds):
    """``builds``: {name: {file name: source text}}. One nvcc -c per source
    of every build, all started together, then one link per build. Returns
    {name: (library path, {file name: nvcc report})}."""
    from ruart_tpu_torch.ops.attention import NVCC_FLAGS, _nvcc

    procs = {}
    for name, sources in builds.items():
        for fname, text in sources.items():
            path = os.path.join(OUT, f"{name}_{fname}")
            with open(path, "w") as f:
                f.write(text)
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   path + ".o", path]
            procs[name, fname] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    reports = {name: {} for name in builds}
    for (name, fname), proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} {fname}: nvcc failed\n{out}")
        reports[name][fname] = out
    libs = {}
    for name, sources in builds.items():
        lib = os.path.join(OUT, name + ".so")
        objs = [os.path.join(OUT, f"{name}_{f}.o") for f in sources]
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                       check=True)
        libs[name] = (lib, reports[name])
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="an earlier attention.cu to time")
    parser.add_argument("--variants", nargs="*", choices=list(PATCHES),
                        default=list(PATCHES), help="bf16 variants to time")
    parser.add_argument("--lengths", nargs="*", type=int, default=[],
                        help="more row lengths at the serving rows, heads")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of every arm, in turns")
    parser.add_argument("--fp32", action="store_true",
                        help="also time K1 fp32 and K3 (change, parent)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ruart_tpu_torch.ops import attention as att

    os.makedirs(OUT, exist_ok=True)
    change = {}
    for src in att.SOURCES:
        with open(src) as f:
            change[src.name] = f.read()
    builds = {"change": change}
    if args.parent:
        with open(args.parent) as f:
            builds["parent"] = {"attention.cu": f.read()}
    for name in args.variants:
        builds[name] = dict(change, **{BF16_SOURCE: patched(
            change[BF16_SOURCE], name)})
    print(cs.card_line(), flush=True)
    libs = {}
    for name, (path, reports) in compile_all(builds).items():
        for fname, report in reports.items():
            if name in ("change", "parent"):
                print(f"{name} {fname}:", flush=True)
                cs.ptxas_report(report)
            elif fname == BF16_SOURCE:
                regs = re.findall(r"Used (\d+) registers", report)
                spills = re.findall(r"(\d+) bytes spill stores", report)
                print(f"{name} {fname}: registers {regs}, spill stores "
                      f"{spills}", flush=True)
        lib = ctypes.CDLL(path)
        if name == "parent":  # one entry for both types
            lib.ruart_attention_rows.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        else:
            lib.ruart_attention_rows.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
            lib.ruart_attention_bf16_rows.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.ruart_flash_attention.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        libs[name] = lib

    def rows_fn(lib, name, shape, bf16):
        """One launch of K1 at ``shape`` through ``lib``'s entry."""
        B, L, H, dh, bias_2d = shape

        def fn(q, k, v, bias):
            out = torch.empty_like(q)
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), B, L, H, dh,
                    int(bias_2d))
            stream = torch.cuda.current_stream().cuda_stream
            if name == "parent":
                err = lib.ruart_attention_rows(*ptrs, int(bf16), dh ** -0.5,
                                               stream)
            elif bf16:
                err = lib.ruart_attention_bf16_rows(*ptrs, dh ** -0.5, stream)
            else:
                err = lib.ruart_attention_rows(*ptrs, dh ** -0.5, stream)
            assert err == 0, (name, err)
            return out
        return fn

    def k1_case(shape, dtype):
        B, L, H, dh, bias_2d = shape
        nbytes = (4 * B * L * H * dh * dtype.itemsize
                  + B * L * (L if bias_2d else 1) * 4)
        sets = [cs.make_inputs(B, L, H, dh, dtype, bias_2d, 7 + i,
                               pad_rows=False, on_grid=False)
                for i in range(cs.n_cold_sets(nbytes))]
        rate = (cs.H100_BF16_FLOP_PER_S if dtype == torch.bfloat16
                else cs.H100_TF32X3_FLOP_PER_S)
        bound = cs.bound(nbytes, 4 * B * H * L * L * dh, rate)[0]
        return sets, att.attention_rows_plain(*sets[0], H), bound

    bf16_cases = {"L32": (cs.SERVE_SHAPE, *k1_case(cs.SERVE_SHAPE,
                                                   torch.bfloat16)),
                  "L512": (cs.CHUNK_SHAPE, *k1_case(cs.CHUNK_SHAPE,
                                                    torch.bfloat16))}
    B, _, H, dh, _ = cs.SERVE_SHAPE
    for L in args.lengths:
        if f"L{L}" not in bf16_cases:
            bf16_cases[f"L{L}"] = ((B, L, H, dh, True),
                                   *k1_case((B, L, H, dh, True),
                                            torch.bfloat16))
    arms = []  # (label, {case: fn})
    for name in libs:
        arms.append((name, {c: rows_fn(libs[name], name, shape, True)
                            for c, (shape, *_) in bf16_cases.items()}))

    def line(rnd, label, cases, fns):
        parts = []
        for c, fn in fns.items():
            _, sets, want, bound = cases[c]
            got = fn(*sets[0])
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            ms = cs.cold_ms(fn, sets)
            parts.append(f"{c} {ms:.4f} ms ({100 * bound / ms:.1f}% of "
                         f"bound {bound:.4f}, err {err:.1e}, "
                         f"{differ:.4%} differ)")
        print(f"round {rnd} {label:12s} " + " | ".join(parts), flush=True)

    print("bf16: K1 at " + ", ".join(f"{c} {shape}" for c, (shape, *_)
                                     in bf16_cases.items()), flush=True)
    for rnd in range(args.rounds):
        for label, fns in (arms if rnd % 2 == 0 else arms[::-1]):
            line(rnd, label, bf16_cases, fns)

    if args.fp32:
        B3, H3, L3, D3 = cs.FLASH_SHAPES[0]
        k3_bytes = 4 * B3 * H3 * L3 * D3 * 4 + B3 * L3 * 4
        k3_sets = [cs.flash_inputs(B3, H3, L3, D3, torch.float32, 30 + i,
                                   False)
                   for i in range(cs.n_cold_sets(k3_bytes))]
        fp32_cases = {
            "K1": (cs.SERVE_SHAPE, *k1_case(cs.SERVE_SHAPE, torch.float32)),
            "K3": (cs.FLASH_SHAPES[0], k3_sets,
                   att.flash_attention_plain(*k3_sets[0]),
                   cs.bound(k3_bytes, 4 * B3 * H3 * L3 * L3 * D3)[0])}

        def k3_fn(lib):
            def fn(q, k, v, bias):
                out = torch.empty(q.shape, dtype=torch.float32,
                                  device=q.device)
                err = lib.ruart_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B3, H3, L3, D3, *q.stride()[:3], 0,
                    D3 ** -0.5, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return out
            return fn

        fp32_arms = [(name, {"K1": rows_fn(libs[name], name, cs.SERVE_SHAPE,
                                           False),
                             "K3": k3_fn(libs[name])})
                     for name in ("change", "parent") if name in libs]
        print(f"fp32: K1 at {cs.SERVE_SHAPE}, K3 at {cs.FLASH_SHAPES[0]}",
              flush=True)
        for rnd in range(args.rounds):
            for label, fns in (fp32_arms if rnd % 2 == 0
                               else fp32_arms[::-1]):
                line(rnd, label, fp32_cases, fns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
