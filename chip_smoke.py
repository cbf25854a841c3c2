#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ruart_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernel is built for sm_90a) and exits
non-zero when there is none, or when any phase fails:

1. Build the attention kernel from ``ruart_tpu_torch/csrc/attention.cu``
   with nvcc and hold it against its plain PyTorch version on the card:
   both bias forms, fp32 and bf16, at the serving path's shapes (H 12,
   dh 64, L 32 and 50, hundreds of rows), at L 512 and at dh 48, with an
   all-pad row in the segment form. Tolerance: 1e-5 abs in fp32, 2e-2 abs
   in bf16. q and k are drawn on a dyadic grid so every score is exact in
   fp32 whatever the summation order: the check then measures the
   kernel's softmax and sums, not fp32 rounding of ``score - 10000`` on a
   query row whose keys are all masked. At dh 48 the scale 1/sqrt(48) is
   inexact, so there every query row keeps a valid key.
2. Serve 40 synthetic requests through ``InferenceEngine.predict`` at the
   flagship width (``stvqa_config(vocab_size=5000, batch_size=16)``,
   BERT-base, random weights from a seeded ``torch.Generator``): three
   batches and a padded tail. Every answer must be a string with a finite
   score, and the kernel must have launched at least 12 times per batch.
   A second pass gives requests per second. Then the kernel, its plain
   version and ``scaled_dot_product_attention`` (the library yardstick,
   used nowhere in the port) are timed at the attention shape the serving
   run gave most often.
3. Run the same batches with ``attention_impl='plain'``: scores must agree
   within 1e-4 abs.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.
"""

import collections
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 40
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12   # fp32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SCORE_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(B, L, H, dh, dtype, bias_2d, seed, pad_rows=True):
    """q, k on a 1/16 grid (exact scores), v ~ N(0, 0.25) — outputs below 2,
    where one bf16 step is 2**-7; the segment bias has
    random packed segments, with pad tails and an all-pad row 0 when
    ``pad_rows``; the key bias has random valid lengths >= 1."""
    import torch

    from ruart_tpu_torch.models.bert.model import attention_bias

    g = torch.Generator(device="cuda").manual_seed(seed)
    D = H * dh

    def grid():
        x = torch.randn(B, L, D, generator=g, device="cuda") * 0.5
        return (torch.round(x * 16) / 16).to(dtype)

    q, k = grid(), grid()
    v = (torch.randn(B, L, D, generator=g, device="cuda") * 0.5).to(dtype)
    ids = torch.ones(B, L, dtype=torch.long, device="cuda")
    if bias_2d:
        seg = torch.zeros(B, L, dtype=torch.long, device="cuda")
        lens = torch.randint(1, 13, (B, L), generator=g, device="cuda").tolist()
        fill = torch.randint(L // 2, L + 1, (B,), generator=g,
                             device="cuda").tolist()
        if not pad_rows:
            fill = [L] * B
        for b in range(1 if pad_rows else 0, B):
            pos, s = 0, 1
            while pos < fill[b]:
                n = min(lens[b][s - 1], fill[b] - pos)
                seg[b, pos:pos + n] = s
                pos, s = pos + n, s + 1
        bias = attention_bias(ids, segment_ids=seg)
    else:
        n = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
        mask = (torch.arange(L, device="cuda")[None] < n[:, None]).long()
        bias = attention_bias(ids, attention_mask=mask)
    return q, k, v, bias.contiguous()


def check_kernel(att):
    """Phase 1: the kernel against its plain version. Returns the worst
    fp32 abs error."""
    import torch

    cases = [  # (rows, L, heads, dh)
        (256, 32, 12, 64), (256, 50, 12, 64), (8, 512, 12, 64),
        (64, 32, 16, 48),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, L, H, dh) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for bias_2d in (True, False):
                q, k, v, bias = make_inputs(B, L, H, dh, dtype, bias_2d, i,
                                            pad_rows=dh == 64)
                got = att.attention_rows_cuda(q, k, v, bias, H)
                torch.cuda.synchronize()
                want = att.attention_rows_plain(q, k, v, bias, H)
                err = (got.float() - want.float()).abs().max().item()
                name = str(dtype).split(".")[-1]
                form = "segment [B,L,L]" if bias_2d else "key [B,L]"
                ok = math.isfinite(err) and err <= TOL[name]
                log(f"kernel check B={B} L={L} H={H} dh={dh} {name} {form}: "
                    f"max |kernel - plain| = {err:.3e} (tol {TOL[name]:g})"
                    f"{'' if ok else '  FAIL'}")
                if not ok:
                    raise AssertionError("attention kernel disagrees with "
                                         "its plain version")
                worst[name] = max(worst[name], err)
    return worst["float32"]


def time_kernel(att, shape):
    """Kernel, plain and SDPA times (ms) at one (rows, L, heads, dh,
    segment-bias) shape, plus the card's bound for that work."""
    import torch
    import torch.nn.functional as F

    B, L, H, dh, bias_2d = shape
    q, k, v, bias = make_inputs(B, L, H, dh, torch.float32, bias_2d, 7)
    ms = cuda_ms(lambda: att.attention_rows_cuda(q, k, v, bias, H))
    plain_ms = cuda_ms(lambda: att.attention_rows_plain(q, k, v, bias, H))
    qh, kh, vh = (t.view(B, L, H, dh).transpose(1, 2) for t in (q, k, v))
    mask = bias[:, None] if bias_2d else bias[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4
    flops = 4 * B * H * L * L * dh
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOP_PER_S * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return ms, plain_ms, lib_ms, max(t_bytes, t_ops), bound_by


def build_engine(attention_impl, params=None):
    import torch

    from ruart_tpu_torch.core.presets import stvqa_config
    from ruart_tpu_torch.data.preprocess import Preprocessor
    from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
    from ruart_tpu_torch.models.bert.config import BertConfig
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.serve import InferenceEngine
    from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab

    cfg = stvqa_config(
        vocab_size=5000, batch_size=16,
        preprocess_ocr_name="ocr_PMTD_ASTER,ES_ocr",
        preprocess_od_name="OD_bottom-up",
    )
    spec = ModelSpec.from_config(cfg, BertConfig(attention_impl=attention_impl))
    # word vocabulary from a processed synthetic corpus, as bench.py builds it
    pre = Preprocessor(cfg)
    corpus = make_synthetic_raw_dataset(
        16, seed=0, n_ocr_range=(15, 30), n_es=40, with_answers=False
    )["data"]
    vocab = pre._build_vocab(pre._process_data(corpus))
    tok = WordPieceTokenizer(build_demo_vocab())
    if params is None:
        params = RUArtModel(spec).init_weights(
            torch.Generator().manual_seed(0)
        ).state_dict()
    return InferenceEngine(cfg, spec, params, vocab, tok), params


def requests():
    from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset

    raw = make_synthetic_raw_dataset(
        N_REQUESTS, seed=3, n_ocr_range=(15, 30), n_es=40, with_answers=False
    )["data"]
    return [
        {"question": d["question"], "image_width": d["image_width"],
         "image_height": d["image_height"], "ocr": d["ocr_PMTD_ASTER"],
         "od": d["OD_bottom-up"], "es": d["ES_ocr"]}
        for d in raw
    ]


def where_the_time_goes(engine, reqs):
    """Split one serving pass into host work (featurize + collate) and
    device work (H2D + forward + score fetch), then profile the device
    part: device-busy share of its wall time and the kernels that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        batches = [b for _, _, b in engine._collated_batches(reqs)]
        host.append(time.perf_counter() - t0)

    def device_pass():
        for q, ocr, od, _gt, _extra in batches:
            with torch.inference_mode():
                engine.model(*(engine.to_device(b) for b in (q, ocr, od))).cpu()

    device = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_pass()
        torch.cuda.synchronize()
        device.append(time.perf_counter() - t0)
    log(f"time (median of 3): host featurize+collate "
        f"{sorted(host)[1] * 1e3:.1f} ms, device h2d+forward+fetch "
        f"{sorted(device)[1] * 1e3:.1f} ms for {len(batches)} batches of "
        f"{engine.batch_size}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        device_pass()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = []  # device-side events only: kernels and copies
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us, e.count, e.key))
    busy = sum(us for us, _, _ in kernels)
    log(f"profile: device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms "
        f"wall ({100 * busy / wall_us:.1f}%, profiler on)")
    for us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{count:<5d} "
            f"{key[:90]}")


def batch_scores(engine, reqs):
    import torch

    out = []
    for _, _, (q, ocr, od, _gt, _extra) in engine._collated_batches(reqs):
        with torch.inference_mode():
            out.append(engine.model(*(engine.to_device(b) for b in (q, ocr, od))))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ruart_tpu_torch")):
        print("chip_smoke: ruart_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ruart_tpu_torch.models.bert.model import BertSelfAttention
    from ruart_tpu_torch.ops import attention as att

    t_start = time.time()
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    # -- phase 1: build + kernel against plain ------------------------------
    t0 = time.time()
    report = att.build_kernel(force=True)
    log(f"phase 1: built {att.LIBRARY.name} in {time.time() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())
    max_err = check_kernel(att)
    log(f"phase 1 ok: worst fp32 error {max_err:.3e}")

    # -- phase 2: serve at full width ---------------------------------------
    t0 = time.time()
    engine, params = build_engine("auto")
    reqs = requests()
    shapes = collections.Counter()

    def record(module, args):
        hidden, bias = args
        shapes[(*hidden.shape[:2], module.heads,
                hidden.shape[2] // module.heads, bias.dim() == 3)] += 1

    hooks = [m.register_forward_pre_hook(record)
             for m in engine.model.modules() if isinstance(m, BertSelfAttention)]
    log(f"phase 2: engine built in {time.time() - t0:.1f} s")
    att.attention_rows_cuda.launches = 0
    results = engine.predict(reqs)
    torch.cuda.synchronize()
    launches = att.attention_rows_cuda.launches
    for h in hooks:
        h.remove()
    n_batches = -(-N_REQUESTS // engine.batch_size)
    log(f"phase 2: {len(results)} answers, {launches} kernel launches over "
        f"{n_batches} batches; attention shapes (rows, L, heads, dh, "
        f"segment) x calls: {dict(shapes)}")
    if len(results) != N_REQUESTS or not all(
        isinstance(r["answer"], str) and r["answer"]
        and math.isfinite(r["score"]) for r in results
    ):
        raise AssertionError(f"bad serving results: {results}")
    if launches < 12 * n_batches:
        raise AssertionError(f"attention kernel launched {launches} times, "
                             f"expected >= {12 * n_batches}")
    t0 = time.time()
    again = engine.predict(reqs)
    torch.cuda.synchronize()
    qps = N_REQUESTS / (time.time() - t0)
    if [r["answer"] for r in again] != [r["answer"] for r in results]:
        raise AssertionError("a second predict pass changed the answers")
    log(f"phase 2 ok: serve {qps:.2f} q/s over {N_REQUESTS} requests, "
        f"batch {engine.batch_size} (second pass)")
    where_the_time_goes(engine, reqs)

    shape = shapes.most_common(1)[0][0]
    ms, plain_ms, lib_ms, bound_ms, bound_by = time_kernel(att, shape)
    log(f"attention at {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    # -- phase 3: the same batches through the plain version -----------------
    plain, _ = build_engine("plain", params)
    got, want = batch_scores(engine, reqs), batch_scores(plain, reqs)
    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    for s in got:
        if not (torch.isfinite(s).all() and
                torch.allclose(s.sum(-1), torch.ones_like(s[:, 0]), atol=1e-4)):
            raise AssertionError("scores are not finite softmax rows")
    plain_answers = [r["answer"] for r in plain.predict(reqs)]
    agree = sum(a == r["answer"] for a, r in zip(plain_answers, results))
    log(f"phase 3: max |score kernel - score plain| = {diff:.3e} "
        f"(tol {SCORE_TOL:g}); answers agree {agree}/{N_REQUESTS}; "
        f"score shape {tuple(got[0].shape)}")
    if not diff <= SCORE_TOL:
        raise AssertionError("kernel path and plain path disagree")

    log(f"total {time.time() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "attention_rows",
        "route": "cuda",
        "source": "ruart_tpu_torch/csrc/attention.cu",
        "replaces": "ruart_tpu/ops/attention.py:100",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
