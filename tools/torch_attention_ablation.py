#!/usr/bin/env python3
"""Time the PyTorch port's attention kernel against variants of itself on
one CUDA card (an H100: the kernels are built for sm_90a).

    python3 tools/torch_attention_ablation.py [--parent OLD_attention.cu]

Builds ``ruart_tpu_torch/csrc/attention.cu`` as it is and with parts of its
work taken out by text patches (each must apply), plus ``--parent`` (an
earlier version of the source with the same C entries, e.g. from
``git show <commit>:ruart_tpu_torch/csrc/attention.cu``), with one nvcc per
variant started together, into ``ruart_tpu_torch/_build/ablation/``. Each
variant is timed at K1's serving shape (136 rows x L 32, 12 heads of 64,
segment bias) and at K3's (16, 12, 128, 64), inputs cold in L2, replayed
from a CUDA graph (``chip_smoke.cold_ms``), in two rounds, the second in
reverse order. Variants:

* ``change`` -- the source as it is;
* ``no_mma`` -- every ``mma.sync`` skipped (the outputs are wrong);
* ``no_split`` -- the small TF32 parts set to 0: the products still run,
  the conversions that make them do not;
* ``skeleton`` -- no products, no small parts, ``expf`` replaced by a
  multiply: the copies, the fragment loads and the stores alone;
* ``hoisted`` -- the compiler free to keep Q's 3xTF32 parts across key
  tiles (twice Q's registers);
* ``maxnreg112`` -- at most 112 registers a thread, for more resident
  blocks;
* ``row_fastest`` -- blocks numbered rows fastest (a grid of (rows x
  query tiles, H)) instead of heads fastest;
* ``divide`` -- each output divided by its row sum instead of multiplied
  by one reciprocal per row;
* ``key_tile16`` -- two key tiles of 16 at 16 < L <= 32, so the second
  tile's copy overlaps the first tile's products.

``--variants`` picks some of them (``change`` always runs).

Prints the card, each variant's registers and spills, and one line per
variant and round with both times, their share of the bytes bound and the
max abs error against the plain version.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = os.path.join(HERE, "ruart_tpu_torch", "csrc", "attention.cu")
OUT = os.path.join(HERE, "ruart_tpu_torch", "_build", "ablation")
PATCHES = {
    "no_mma": [('  asm volatile(\n      "mma.sync',
                '  return;\n  asm volatile(\n      "mma.sync')],
    "no_split": [("  small = tf32(x - __uint_as_float(big));",
                  "  small = 0u;")],
    "skeleton": [('  asm volatile(\n      "mma.sync',
                  '  return;\n  asm volatile(\n      "mma.sync'),
                 ("  small = tf32(x - __uint_as_float(big));",
                  "  small = 0u;"),
                 ("#include <stdint.h>",
                  "#include <stdint.h>\n#define expf(x) ((x) * 0.5f)")],
    "hoisted": [('''      asm volatile("" : "+f"(qa[d].x), "+f"(qa[d].y), "+f"(qa[d].z),
                   "+f"(qa[d].w), "+f"(qb[d].x), "+f"(qb[d].y), "+f"(qb[d].z),
                   "+f"(qb[d].w));
''', "")],
    "maxnreg112": [("__global__ void __launch_bounds__(kMaxWarps * 32)",
                    "__global__ void __maxnreg__(112)")],
    "row_fastest": [
        ("  const int h = blockIdx.x;\n"
         "  const int r = blockIdx.y + blockIdx.z * gridDim.y;",
         "  const int h = blockIdx.y;\n  const int r = blockIdx.x;"),
        ("    fn<<<dim3((unsigned)H, y, z),",
         "    fn<<<dim3((unsigned)rows, (unsigned)H),")],
    "divide": [("  const float inv[2] = {kRoundP ? 1.f : 1.f / l[0],\n"
                "                        kRoundP ? 1.f : 1.f / l[1]};\n",
                "  const float inv[2] = {kRoundP ? 1.f : l[0],\n"
                "                        kRoundP ? 1.f : l[1]};\n"),
               ("    const float c0 = acc[n][0] * inv[0], c1 = acc[n][1] * inv[0];\n"
                "    const float c2 = acc[n][2] * inv[1], c3 = acc[n][3] * inv[1];",
                "    const float c0 = acc[n][0] / inv[0], c1 = acc[n][1] / inv[0];\n"
                "    const float c2 = acc[n][2] / inv[1], c3 = acc[n][3] / inv[1];")],
    "key_tile16": [("  p.ktile = L > kKeyTile ? kKeyTile : (L + 7) / 8 * 8;",
                    "  p.ktile = L > kKeyTile ? kKeyTile\n"
                    "            : L > 16     ? 16\n"
                    "                         : (L + 7) / 8 * 8;")],
}


def build(name, src):
    from ruart_tpu_torch.ops.attention import _nvcc

    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, name + ".so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib,
           path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load(lib):
    lib = ctypes.CDLL(lib)
    lib.ruart_attention_rows.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.ruart_flash_attention.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="an earlier attention.cu to time")
    parser.add_argument("--variants", nargs="*", choices=list(PATCHES),
                        default=list(PATCHES), help="variants to time")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ruart_tpu_torch.ops import attention as att

    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        source = f.read()
    sources = {}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    sources["change"] = source
    for name in args.variants:
        src = source
        for old, new in PATCHES[name]:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: patch does not apply: {old!r}")
            src = src.replace(old, new)
        sources[name] = src
    print(cs.card_line(), flush=True)
    builds = {name: build(name, src) for name, src in sources.items()}
    libs = {}
    for name, (proc, lib) in builds.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{report}")
        regs = re.findall(r"Used (\d+) registers", report)
        spills = re.findall(r"(\d+) bytes spill stores", report)
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        libs[name] = load(lib)

    B, L, H, dh, _ = cs.SERVE_SHAPE
    k1_bytes = 4 * B * L * H * dh * 4 + B * L * L * 4
    k1_sets = [cs.make_inputs(B, L, H, dh, torch.float32, True, 7 + i,
                              pad_rows=False, on_grid=False)
               for i in range(cs.n_cold_sets(k1_bytes))]
    B3, H3, L3, D3 = cs.FLASH_SHAPES[0]
    k3_bytes = 4 * B3 * H3 * L3 * D3 * 4 + B3 * L3 * 4
    k3_sets = [cs.flash_inputs(B3, H3, L3, D3, torch.float32, 30 + i, False)
               for i in range(cs.n_cold_sets(k3_bytes))]
    want1 = att.attention_rows_plain(*k1_sets[0], H)
    want3 = att.flash_attention_plain(*k3_sets[0])
    k1_bound = cs.bound(k1_bytes, 4 * B * H * L * L * dh)[0]
    k3_bound = cs.bound(k3_bytes, 4 * B3 * H3 * L3 * L3 * D3)[0]
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = libs[name]

            def k1(q, k, v, bias, lib=lib):
                out = torch.empty_like(q)
                err = lib.ruart_attention_rows(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B, L, H, dh, 1, 0, dh ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return out

            def k3(q, k, v, bias, lib=lib):
                out = torch.empty(q.shape, dtype=torch.float32,
                                  device=q.device)
                err = lib.ruart_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), B3, H3, L3, D3, *q.stride()[:3], 0,
                    D3 ** -0.5, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return out

            e1 = (k1(*k1_sets[0]) - want1).abs().max().item()
            e3 = (k3(*k3_sets[0]) - want3).abs().max().item()
            t1, t3 = cs.cold_ms(k1, k1_sets), cs.cold_ms(k3, k3_sets)
            print(f"round {rnd} {name:9s} K1 {t1:.4f} ms "
                  f"({100 * k1_bound / t1:.1f}% of bound, err {e1:.1e}) | "
                  f"K3 {t3:.4f} ms ({100 * k3_bound / t3:.1f}% of bound, "
                  f"err {e3:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
