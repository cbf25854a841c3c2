#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ruart_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--cupti-default]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero when there is none, or when any phase fails:

1. Build ``ruart_tpu_torch/csrc/attention.cu``, ``attention_bf16.cu`` and
   ``gemm_tf32x3.cu`` with nvcc, one process per source started together
   (print each kernel's registers and spills from ``-Xptxas -v`` and the
   blocks an SM keeps resident at the timed shapes) and hold the
   model-layout kernels
   (K1/K2: ``attention.cu`` in fp32, ``attention_bf16.cu`` in bf16)
   against their plain PyTorch version on the card: both bias forms,
   fp32 and bf16, at the serving path's shapes (H 12, dh 64, L 32 and 50,
   hundreds of rows), at L 512 and at dh 48, then at the edges of the
   kernel's tiling (L 1, 17, 65, 128 and 130; dh 8 and 128), with an
   all-pad row in the segment form. Tolerance: 1e-5 abs in fp32, 2e-2 abs
   in bf16. These q and k are drawn on a dyadic grid so every score is
   exact in fp32 whatever the summation order: the check then measures the
   kernel's softmax and sums, not fp32 rounding of ``score - 10000`` on a
   query row whose keys are all masked. Where 1/sqrt(dh) is inexact (dh 8,
   48, 128) every query row keeps a valid key. Then fp32 cases off the grid
   (not exact in TF32, every query keeping a valid key) at the serving
   shape and at L 128: a kernel that dropped its 3xTF32 split would miss
   1e-5 there. Then q/k/v at an address off 16-byte alignment, which the
   kernels stage element by element. Then a race check: 200 launches of
   the bf16 kernel on the same inputs at the serving shape and at (8, 512,
   12, 64), segment bias, must each be byte-equal to the first. Last (g),
   ``tools/torch_kernel_sanitize.py`` in child Pythons: a sweep that
   launches every kernel of the library (counted by name under the
   profiler against nvcc's list; every head width, both bias forms, L 1 to
   512, the grid's y/z split, unaligned inputs, K3, a tp shard) between
   guard bands (a read past an input that reaches the output, or a write
   past the output, shows) and against the plain version; the same sweep
   under ``compute-sanitizer --tool memcheck`` and K1 at the race check's
   shapes under racecheck and synccheck, 0 errors each. compute-sanitizer
   must be installed; where it cannot attach to the card, that is printed.
   (h) G1, the encoder's fp32 Linears (``csrc/gemm_tf32x3.cu``, built with
   the attention sources): at the benchmark cells' token counts (4,352,
   7,936, 14,592) each Linear of a layer (Q/K/V in one launch, the
   intermediate with its gelu), at ragged M and at the tp 2 shards'
   widths, against an fp64 product and cuBLAS's FFMA ``F.linear`` on the
   same inputs: G1's worst error (over the scale |x| |w|^T of each sum)
   within twice FFMA's worst; the edges of its 128 x 128 tile (M 1 and
   130, N 128 and 256, K of one stage), within 1e-5; a launch captured in a CUDA graph and replayed on new inputs
   byte-equal to an eager launch; the autograd path's gradients within
   1e-5 of ``F.linear``'s; bf16, a non-contiguous input, K or N it does
   not take and a CPU weight refused. One layer's launches timed hot in
   L2 beside the plain version and FFMA ``F.linear``. Every path of the
   later phases counts G1's launches beside K1's: 4 a layer in fp32 (the
   serving run of phase 2 is held to it), none under ``BF16`` or
   ``INT8_BERT``.
   (i) The Moonlight encoder's kernels (``csrc/moe_bf16.cu``: route,
   permute, the grouped gate/up and down products, combine; the bf16
   attention at 192-wide query/key and 128-wide value heads) against
   their plain twins on the same inputs: the training cell's 4,352 tokens
   at top 6 of 64 experts of 2,048 x 1,408, small ragged shapes, each
   straight and skewed (experts with no rows, one with most): the same
   experts, counts and routed-row counter, weights within 1e-6, the
   permutation consistent, the products and the combine within 1e-2 of
   their scale; the layer replayed from a CUDA graph on new inputs
   byte-equal to its eager run; the attention at L 1 to 512, both bias
   forms, within 2e-2. Then one expert layer and the attention at the
   training shapes, timed beside their bounds and plain twins. Then RUArt
   over the Moonlight encoder at its published widths (``LLM_ENCODER``,
   ``BF16``) through ``make_eval_step`` and ``evaluate`` on 48 items:
   graph replays equal to the capture pass, the eager step's loss within
   1e-5, the routed-row counter at 6 routes a token in all 26 expert
   layers, and each pass's launches counted (set to 0 just before it,
   read just after): per encoder call 26 route, 26 permute, 52 grouped
   GEMM and 26 combine launches and 27 of the 192/128 attention, printed
   in the kernels line.
2. Serve 40 synthetic requests through ``InferenceEngine.predict`` at the
   flagship width (``stvqa_config(vocab_size=5000, batch_size=16)``,
   BERT-base, random weights from a seeded ``torch.Generator``): three
   batches and a padded tail. Every answer must be a string with a finite
   score, and the kernel must have launched at least 12 times per batch.
   A second pass gives requests per second. Then the kernel, its plain
   version and ``scaled_dot_product_attention`` (the library yardstick,
   used nowhere in the port) are timed at the attention shape the serving
   run gave most often, and at K2's: each replayed from a CUDA graph over
   copies of the inputs that hold more than 100 MB together, so every call
   finds them cold in L2. Each time is printed beside its bound (bytes
   over 3.35 TB/s, or fp32 operations over the 165 TFLOP/s of 3xTF32 on
   the tensor cores) and the share of the bound it reaches.
3. Run the same batches with ``attention_impl='plain'``: scores must agree
   within 1e-4 abs.
4. ``flash_attention`` (K3, the head-major kernel) against its plain
   version: fp32 and bf16 inputs (fp32 output) at [B, H, L, D] = (16, 12,
   128, 64), at the tiling's edges (L 1, 16, 17, 50, 65, 128, 512; D 8,
   48, 64, 128) with an all-masked key tail, fp32 off the grid at
   (16, 12, 128, 64), and rows 65 elements apart (not 16-byte aligned);
   tolerances as phase 1. K3, its plain version and
   SDPA are timed at (16, 12, 128, 64) as in phase 2.
5. The attention's ``autograd.Function`` (kernel forward, backward through
   the plain version) against the plain version under autograd at the
   serving shape (136 packed rows x L 32, 12 heads of 64, segment bias):
   output and q/k/v gradients within 1e-5 abs in fp32.
6. Train at full width through ``python -m ruart_tpu_torch.cli.main``'s
   entry point: the shipped ST-VQA train conf (LOCK_BERT, TUNE_PARTIAL 1000,
   dropout, Adamax, BCE_D1, clip 10) at batch 16, BERT-base, synthetic
   msgpack data in a fresh directory under ``_scratch/`` (320 training items with ~4,900
   words of vocabulary: 20 steps, eval at the start and the end), then
   ``cli.main_test`` from ``ANLS_best_model.ckpt``. The train step replays
   one CUDA graph per batch signature (the trainer's default on a card;
   captures, seconds per capture and the train graph pool's bytes are
   printed). Every loss must be
   finite, the checkpoints must exist, ``submission.json`` must hold one
   entry per test item, and the kernel must launch in every step; the eval
   step's CUDA graph for the first val batch, captured at the evaluation
   before the first step, must replay the trained weights (scores within
   1e-6 of the eager step's, no new capture). Prints
   the median step time (10 steps on one batch, each ended by a
   synchronize), steps/s of the CLI's loop, eval q/s of the prediction
   (the CLI's first pass, and the median of three warm passes of the same
   evaluator),
   the peak device memory and profiled steps (device-busy share, top
   kernels, top host operations).
7. One eager train step (``graphs=False``: its gradients are read) on
   the card with the kernel and again with
   ``attention_impl='plain'``, dropout off, the same weights and batch:
   loss within 1e-5 relative, updated parameters within 0.05 * lr abs
   wherever the two arms pin the gradient down to 1% and above 1e-7.
   Elsewhere Adamax turns rounding noise into a step of up to lr either
   way: there each arm must stay within lr of the start. The largest
   gradient difference (over the global gradient norm) is printed beside
   the plain arm's difference from a second plain step.
8. The serving stack at the width of phase 2, on the same 40 requests:
   (a) the pipelined ``predict`` against the serial path (answers equal,
   scores within 1e-4 of it and of phase 2; q/s of three calls each, in
   turns); (b) on eager engines (``graphs=False``: a forward hook
   records each batch's signature), ``warmup_calibrated`` and
   ``warmup(max_programs=32)``
   (counts and seconds; every signature of the batches served afterwards
   was warmed) and the first pass of a fresh engine with and without
   warmup; (c) ``BatchingServer(max_wait_ms=10)``: two bursts of the 40
   requests with the answers of ``predict``, ``stats()``, one lone
   request; (d) a ``num_worker 2`` engine: collated batches byte-equal to
   serial, equal answers, q/s against serial; (e) ``quantize()``: the int8
   encoder with the kernel against the int8 plain path (scores within
   1e-4), answer agreement with fp32, q/s, encoder weight bytes; (f) in
   phase 6's run folder, ``cli.serve_main`` with ``--warmup 8``, fp32 and
   ``INT8_BERT``, 40 lines with the answers of an engine loaded from the
   same checkpoint, and ``cli.main_test`` under ``INT8_BERT``. Each path
   runs with the launch counts set to 0 and must launch K1 12 times per
   batch (once per layer: the question and candidate rows share one
   encoder call).
9. The model's other conf branches at the width of phase 2. (a) ``BF16``
   serving: the 40 requests through ``predict`` with the kernel, with
   ``attention_impl='plain'`` and in fp32; kernel-vs-plain bf16 scores
   must lie no further apart than plain bf16 lies from fp32, and the two
   bf16 runs must agree on at least 38 of the 40 answers; q/s of bf16 and
   fp32 in turns (for information); K1 bf16 timed at the serving shape
   beside SDPA in bf16 and its bound (bytes, or bf16 products at the data
   sheet's dense 989 TFLOP/s), and at the chunk shape of phase 11 (4 x L
   512, key bias; printed, not checked). (b) ``BF16`` with
   ``INT8_BERT``: one pass, finite scores. (c) ``BF16`` training through
   ``cli.main``: 10 steps of the shipped train conf at batch 16 in phase
   6's folder, every loss finite and K1 in bf16 in every step; then one
   eager step with ``LOCK_BERT`` off, whose encoder gradients must be
   finite and not all zero (the bf16 backward through the
   ``autograd.Function``).
   (d) One full-width forward each of ``img_feature replace_od`` (36 x 2048
   synthetic region features), ``fixed_answers`` (a 4,000-line synthetic
   answer file) and ``ES_using_way post_process``, kernel against plain
   path: scores within 1e-4. Every path runs with the counts set to 0 and
   must launch K1 12 times per batch or step, in bf16 where ``BF16`` is on.
10. The (dp, tp) mesh. (a) ``sharded_fused_attention`` at the serving
   shape in both bias forms, fp32 and bf16: the whole grid of shards in
   one process (``sharded_fused_attention_global``, each shard through the
   kernel on its local heads) at (dp, tp) in (2, 1), (1, 2), (2, 2) and
   (1, 4), against K1 over all heads and against the plain version with
   phase 1's tolerances; tp 5 over 12 heads must be refused. K1 timed on a
   tp shard's 6 and 3 heads (136 rows x L 32) as in phase 2, beside SDPA
   and the bound. (b) NCCL through ``maybe_initialize_distributed`` at
   world size 1 (localhost ``coordinator_address``): one all_reduce. (c)
   Two ranks on the one card over gloo (NCCL refuses two ranks of one
   communicator on one device), started by ``parallel.launch.spawn``,
   through the conf keys and the trainer at the width of phase 2 with its
   weights (a checkpoint loaded by ``Trainer.load_model``): gloo's
   all_reduce, all_gather and broadcast on CUDA tensors; then at dp 2 and
   at tp 2 the forward of phase 2's three batches (scores within 1e-4 of
   phase 3's kernel path) and one train step of the shipped train conf on
   the first batch with seeded targets (loss within 1e-5 relative and
   parameters within 0.05 * lr of the single-process kernel path's eager
   step where the two gradients agree to 1% and exceed 1e-7, as in phase
   7),
   K1 launched on every rank on 12 heads at dp 2 and on 6 at tp 2;
   at tp 2 a full checkpoint that rank 0 alone writes, which gives a
   single-process trainer the ranks' scores within 1e-4. The wall time is
   printed; two ranks sharing one card measure correctness, not speed.
11. The last modules, at the width of phase 2. (a) g++ builds the PHOC
   library and the fastcollate extension (seconds printed; the collator
   must run natively); the native PHOC encoder over 5,000 words (the
   engine's vocabulary and seeded words) byte-equal to its Python oracle,
   and ``phoc_from_char_ids`` on the card byte-equal to it; the 40
   requests' batches collated natively byte-equal to the numpy path, and
   host featurize + collate ms per pass with each, in turns. (b) ``PHOC``
   (``phoc`` in ``ocr_embedding``, a 5,000 x 604 table): the 40 requests
   through ``predict`` with the kernel and with the plain path, scores
   within 1e-4; one train step of the shipped train conf with ``PHOC`` and
   ``fixed_answers`` (4,000 answers) through the trainer, preprocessed
   anew (the preprocessor writes the table): ``fixed_answers_phoc``
   [4000, 604] byte-equal to the oracle, a finite loss on seeded targets
   of the head's width. (c) BERT-base over 4 rows of L 1,024 with a key
   mask through ``encode_chunked`` (2 chunks of 512), kernel against
   plain within 1e-4; K1 timed at the chunk's shape beside SDPA and its
   bound; ``BertWordEncoder`` on a serving batch's question rows, kernel
   against plain within 1e-4. (d) ``forward_with_attention`` on a serving
   batch: scores within 1e-6 of the forward ``predict`` runs, every alpha
   finite with rows summing to 1, and as many device kernels per forward
   with recording off (before and after) as with it on: each of the three
   counts is the most frequent of 3 profiled forwards, each region
   starting with spin kernels left out of the count (the profiler misses
   a session's first events now and then; the raw counts are printed).
   (e) One
   forward inside
   ``profiler_trace``: its trace names K1's kernel. Every path runs with
   the counts set to 0 and must launch K1 12 times per batch, chunk or
   step.
12. The eval step as one CUDA graph per batch signature (the engine's and
   the trainer's default on a card; phases 2-11 serve through it too,
   except phase 8 b, whose forward hooks need the eager engine, and a
   path checked for exactly 12 K1 launches per batch runs once to capture
   before its driven pass). (a) fp32, ``BF16`` and ``INT8_BERT``: a graph
   engine against an eager one (``graphs=False``) on the 40 requests,
   answers and idx equal, scores within 1e-6 (each batch's forward
   byte-equal or within 1e-6), K1 exactly 12 per batch on both (the
   replay-aware count). (b) ``warmup_calibrated`` on a fresh graph
   engine: one graph per signature, the live pass captures nothing; the
   capture seconds per signature and the graph pool's bytes. (c)
   ``BatchingServer`` on a fresh graph engine: the burst's signatures met
   cold inside ``dispatch`` while the gather thread prepares, answers as
   ``predict``'s, a lone request as the eager engine's, one graph per
   signature. (d) ``cli.main_test`` from phase 6's checkpoint on graphs and
   eager: equal submissions. (e) fp32 and ``BF16``, graphs against eager
   in turns (medians of 3): serve q/s, host ms per batch, device-busy
   share, device kernels and host launch calls per batch (profiler on).
   (f) ``INT8_BERT`` at tp 2 on two gloo ranks on the one card (the int8
   layers whole on each rank, K1 over all 12 heads; a mesh keeps the step
   eager) against the single-process int8 eval step: scores within 1e-4.
13. The train step as one CUDA graph per batch signature, from phase 6's
   trained weights and the first 5 training batches, each taken twice
   (10 steps, dropout on, the same generator seed in every arm); graph
   arms built by ``make_train_step(..., graphs=True)``, eager arms by
   ``graphs=False``. (a) Per configuration — the shipped conf in fp32,
   ``BF16``, ``LOCK_BERT`` off — the eager-against-eager spread first
   (eager is not byte-stable: the embedding and index backward add with
   atomics), then graphs against eager: in fp32 and ``BF16`` byte-equal
   (losses and every trainable parameter) under PyTorch's deterministic
   kernels, where two eager arms are byte-equal; with ``LOCK_BERT`` off,
   which does not capture under those kernels, the median difference of
   five runs of a graph arm (the later ones reset it in place and replay
   its captures) from an eager arm within twice the largest spread of
   three eager arms (one run's difference is a draw from the same spread,
   and failed that limit once with nothing wrong; the median of three
   failed it once in 20 runs). Losses, max
   |param diff| and each check's margin printed. (b)
   K1 12 launches per step on both paths by the replay-aware count (in
   bf16 under ``BF16``); kernel-launch calls and graph launches per step
   on the host (profiler). (c) fp32 eager against graphs in turns: 3
   rounds of 10 synchronized steps, the median of each, and the
   device-busy share of a profiled step. (d) Phase 6's captures, seconds
   per capture and train graph pool bytes. (e) A registered generator's
   draws replayed equal to eager's; a capture with an unregistered one
   raises, naming the signature. (f) Between (a) and (c): three more
   LOCK_BERT-off graph arms, each built, run for its 10 steps (K1 12 per
   step) and dropped, so that (c) replays the kept graph arm under the
   profiler after other train graphs of the process were torn down.
   While the dropped steps' graphs waited for Python's cyclic collector,
   a collection between (c)'s profiler sessions freed them, and the next
   profiled replay segfaulted inside CUPTI's callback on
   ``cuGraphLaunch`` (PERF.md, section 6); the port's graphs now go when
   their owner does. The smoke leaves CUPTI at PyTorch's settings;
   ``--cupti-default`` also clears ``TEARDOWN_CUPTI`` and
   ``DISABLE_CUPTI_LAZY_REINIT`` from the environment first. (g) After
   (c), graphs released between two profiler sessions: a graph engine
   captures its signatures of the 40 requests and a LOCK_BERT-off graph
   train step runs its 10 steps; a first session replays the kept fp32
   graph arm (one step) and the engine's eval graphs (one ``predict``);
   outside any session the train step is released
   (``TrainStep.release``) and dropped, every graph of it gone; a second
   session replays the kept train graph and the eval graphs again (K1 12
   per step or batch in each, no new capture). Prints the graphs
   destroyed between the sessions and the graph launches in each.

Checks whose pass depends on chance (a timing, a profiler count, the
spread of runs that add with atomics) print their margin, the value over
its limit.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import faulthandler
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_REQUESTS = 40
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
# fp32-accurate products on the tensor cores: 3xTF32, a third of the data
# sheet's 495 TFLOP/s TF32 (fp32 outside the tensor cores is 67 TFLOP/s)
H100_TF32X3_FLOP_PER_S = 495e12 / 3
# bf16 products on the tensor cores, dense (H100 SXM data sheet)
H100_BF16_FLOP_PER_S = 989e12
COLD_BYTES = 100 * 10**6        # inputs rotated through per timing (L2: 50 MB)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SCORE_TOL = 1e-4
GRAD_TOL = 1e-5
SERVE_SHAPE = (136, 32, 12, 64, True)   # packed rows, L, heads, dh, segment
FLASH_SHAPES = [  # [B, H, L, D]: the timed shape first, then tiling edges
    (16, 12, 128, 64), (3, 2, 16, 8), (2, 4, 50, 64), (4, 3, 1, 64),
    (3, 2, 17, 8), (2, 3, 65, 48), (2, 2, 128, 128), (1, 2, 512, 128),
    (2, 2, 512, 64),
]
K2_SHAPE = (64, 32, 16, 48, True)
N_TRAIN, N_VAL, N_TEST = 320, 32, 40
UNIQUE_ES = 15   # ES words per training item made unique: ~4,900 words
LR = 1e-3
N_FIXED = 4000   # the reference's fixed_answers_4000.txt
IMG = (36, 2048)  # bottom-up regions x feature width


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


def make_inputs(B, L, H, dh, dtype, bias_2d, seed, pad_rows=True,
                on_grid=True):
    """q, k ~ N(0, 0.25), on a 1/16 grid (exact scores, exact in TF32) when
    ``on_grid``; v ~ N(0, 0.25) — outputs below 2, where one bf16 step is
    2**-7; the segment bias has random packed segments, with pad tails and
    an all-pad row 0 when ``pad_rows`` (else every query keeps a valid
    key); the key bias has random valid lengths >= 1."""
    import torch

    from ruart_tpu_torch.models.bert.model import attention_bias

    g = torch.Generator(device="cuda").manual_seed(seed)
    D = H * dh

    def grid():
        x = torch.randn(B, L, D, generator=g, device="cuda") * 0.5
        return (torch.round(x * 16) / 16 if on_grid else x).to(dtype)

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


def unaligned(x):
    """The values of contiguous ``x`` at an address one element past a
    16-byte boundary."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def padded_rows(x):
    """[B, H, L, D] ``x`` as a view whose rows lie D + 1 elements apart."""
    import torch

    buf = torch.zeros(*x.shape[:-1], x.shape[-1] + 1, dtype=x.dtype,
                      device=x.device)
    buf[..., :-1] = x
    return buf[..., :-1]


def check_kernel(att):
    """Phase 1: the kernel against its plain version. Returns the worst
    fp32 abs error of the shapes the JAX package sends to K1
    (``_packed_kernel``: dh divides 128 and heads fill the bundles) and of
    those it sends to K2, and the worst bf16 error of K1's shapes."""
    import torch

    cases = [  # (rows, L, heads, dh): serving lengths, then edges of the tiling
        (256, 32, 12, 64), (256, 50, 12, 64), (8, 512, 12, 64),
        (64, 32, 16, 48), (64, 1, 4, 64), (64, 17, 4, 64), (32, 65, 4, 64),
        (16, 128, 12, 64), (16, 32, 4, 8), (16, 50, 4, 128), (4, 130, 2, 128),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    by_kernel = {"K1": 0.0, "K2": 0.0, "K1 bf16": 0.0}

    def check(B, L, H, dh, dtype, bias_2d, seed, on_grid, shift=False):
        # an all-pad query row compares fp32 roundings of score - 10000:
        # only where the scores are exact (q, k on the grid and 1/sqrt(dh)
        # a power of two)
        q, k, v, bias = make_inputs(B, L, H, dh, dtype, bias_2d, seed,
                                    pad_rows=on_grid and dh in (16, 64),
                                    on_grid=on_grid)
        if shift:  # not 16-byte aligned: the kernel's per-element staging
            q, k, v = (unaligned(x) for x in (q, k, v))
        got = att.attention_rows_cuda(q, k, v, bias, H)
        torch.cuda.synchronize()
        want = att.attention_rows_plain(q, k, v, bias, H)
        err = (got.float() - want.float()).abs().max().item()
        name = str(dtype).split(".")[-1]
        form = "segment [B,L,L]" if bias_2d else "key [B,L]"
        ok = math.isfinite(err) and err <= TOL[name]
        # in bf16 one rounding step of the output is the error's floor: the
        # share of outputs that differ says how often the two round apart
        differ = (f", {(got != want).float().mean().item():.3%} of outputs "
                  f"differ" if dtype == torch.bfloat16 else "")
        log(f"kernel check B={B} L={L} H={H} dh={dh} {name} {form}"
            f"{'' if on_grid else ' off-grid'}{' unaligned' if shift else ''}"
            f": max |kernel - plain| = "
            f"{err:.3e} (tol {TOL[name]:g}){differ}{'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError("attention kernel disagrees with its plain "
                                 "version")
        worst[name] = max(worst[name], err)
        packed = 128 % dh == 0 and H % (128 // dh) == 0
        kernel = "K1" if packed else "K2"
        if name == "bfloat16":
            kernel = "K1 bf16" if packed else None
        if kernel:
            by_kernel[kernel] = max(by_kernel[kernel], err)

    for i, (B, L, H, dh) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            for bias_2d in (True, False):
                check(B, L, H, dh, dtype, bias_2d, i, True)
    # q, k off the grid are not exact in TF32: a kernel that dropped the
    # 3xTF32 split would miss 1e-5 here by two orders of magnitude
    B, L, H, dh, _ = SERVE_SHAPE
    for j, (B, L, H, dh) in enumerate([(B, L, H, dh), (16, 128, 12, 64)]):
        for bias_2d in (True, False):
            check(B, L, H, dh, torch.float32, bias_2d, 100 + j, False)
    for dtype in (torch.float32, torch.bfloat16):
        check(64, 50, 4, 64, dtype, True, 110, True, shift=True)
    log(f"phase 1: worst bf16 error {worst['bfloat16']:.3e}")
    return by_kernel


RACE_SHAPES = (SERVE_SHAPE, (8, 512, 12, 64, True))
RACE_LAUNCHES = 200


def race_check(att):
    """Phase 1: RACE_LAUNCHES launches of the bf16 kernel on the same inputs
    at each of RACE_SHAPES, every output byte-equal to the first: a read of
    shared memory before its copy has landed, or a tile refilled while a
    warp still reads it, shows as an output that changes between launches."""
    import torch

    for B, L, H, dh, bias_2d in RACE_SHAPES:
        x = make_inputs(B, L, H, dh, torch.bfloat16, bias_2d, 120,
                        on_grid=False)
        first = att.attention_rows_cuda(*x, H)
        apart = sum(not torch.equal(att.attention_rows_cuda(*x, H), first)
                    for _ in range(RACE_LAUNCHES - 1))
        torch.cuda.synchronize()
        log(f"phase 1: race check at {(B, L, H, dh, bias_2d)}: "
            f"{RACE_LAUNCHES} launches of the bf16 kernel, {apart} not "
            f"byte-equal to the first")
        if apart:
            raise AssertionError("the bf16 attention kernel is not "
                                 "deterministic")


SANITIZE_TOOL = os.path.join("tools", "torch_kernel_sanitize.py")
SANITIZE_TIMEOUT = 600  # seconds for each child of phase 1 (g)
# What each compute-sanitizer child printed on the one card it was tried on,
# where it could not attach: its refusal, then the child's first
# allocation failing with cudaErrorUnknown (999), so no kernel ran.
SANITIZER_NOT_ATTACHED = ("Error: Device not supported",
                          "CUDA error: unknown error")


def compute_sanitizer() -> str:
    """The toolkit's compute-sanitizer: on the PATH, else beside nvcc."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "compute-sanitizer")
    if not os.access(path, os.X_OK):
        raise AssertionError("phase 1: compute-sanitizer is not on the PATH "
                             f"nor at {path}: the sanitizer sweep cannot run")
    return path


def sanitizer_errors(tool: str, out: str):
    """The error count of a compute-sanitizer run's summary line, or None
    when the output has none (the run did not reach its end)."""
    pattern = (r"RACECHECK SUMMARY: \d+ hazards? displayed \((\d+) errors?"
               if tool == "racecheck" else r"ERROR SUMMARY: (\d+) errors?")
    found = re.findall(pattern, out)
    return int(found[-1]) if found else None


def sanitizer_not_attached(returncode: int, out: str, result: dict) -> bool:
    """True only for that failure exactly: a non-zero exit, both messages of
    SANITIZER_NOT_ATTACHED, and no result line from the sweep (it launched
    nothing). Any other failure is a verdict and fails the phase."""
    return (returncode != 0 and not result
            and all(text in out for text in SANITIZER_NOT_ATTACHED))


def sanitize(report: str):
    """Phase 1 (g): every kernel of the library launched by
    ``tools/torch_kernel_sanitize.py`` in child Pythons started together.
    (1) Without a sanitizer, under torch.profiler: each kernel of nvcc's
    list (``report``) launched, each launch between guard bands (a read
    past an input that reaches the output, or a write past the output,
    shows) and within its plain version's tolerance. (2) Under
    compute-sanitizer: the sweep under memcheck (no caching allocator) and
    K1 at RACE_SHAPES under racecheck and synccheck, each with 0 errors.
    Where compute-sanitizer cannot attach to the card
    (``sanitizer_not_attached``), that is printed and (2) has no verdict; a
    missing compute-sanitizer, an error it reports, any other failed or
    unfinished child fail the phase."""
    sanitizer = compute_sanitizer()
    fd, report_file = tempfile.mkstemp(suffix=".txt")
    with os.fdopen(fd, "w") as f:
        f.write(report)
    tool = [sys.executable, os.path.join(HERE, SANITIZE_TOOL)]
    runs = {
        "guards": (tool + ["--count", "--report", report_file], {}),
        "memcheck": ([sanitizer, "--tool", "memcheck", "--error-exitcode", "1"]
                     + tool, {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"}),
        "racecheck": ([sanitizer, "--tool", "racecheck", "--error-exitcode",
                       "1"] + tool + ["--race"], {}),
        "synccheck": ([sanitizer, "--tool", "synccheck", "--error-exitcode",
                       "1"] + tool + ["--race"], {}),
    }
    t0 = time.time()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    cwd=HERE, env=dict(os.environ, **env))
             for name, (cmd, env) in runs.items()}
    failures, results, errors = [], {}, {}
    try:
        for name, proc in procs.items():
            try:
                out = proc.communicate(timeout=SANITIZE_TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0] + "\n(killed at the time limit)"
            lines = out.strip().splitlines()
            # the tool's JSON line, before the sanitizer's summary
            result = next((json.loads(line) for line in reversed(lines)
                           if line.startswith('{"mode"')), {})
            results[name] = result
            detached = name != "guards" and sanitizer_not_attached(
                proc.returncode, out, result)
            if name == "guards":
                ok = (proc.returncode == 0 and result.get("launches")
                      and not result.get("disagree")
                      and not result.get("missing"))
                log(f"phase 1 (g): guard sweep: rc {proc.returncode}, "
                    f"{result.get('covered')} of {result.get('library')} "
                    f"kernels launched in {result.get('launches')} launches, "
                    f"guard bands intact and worst error / tolerance "
                    f"{result.get('worst_err_over_tol')}")
            elif detached:
                ok, errors[name] = True, None
                log(f"phase 1 (g): compute-sanitizer --tool {name} cannot "
                    f"attach to this card (rc {proc.returncode}, "
                    f"{SANITIZER_NOT_ATTACHED[0]!r}, then "
                    f"{SANITIZER_NOT_ATTACHED[1]!r}): no verdict")
            else:
                errors[name] = sanitizer_errors(name, out)
                ok = (proc.returncode == 0 and errors[name] == 0
                      and result.get("launches")
                      and not result.get("disagree"))
                log(f"phase 1 (g): compute-sanitizer --tool {name}: rc "
                    f"{proc.returncode}, {errors[name]} errors in "
                    f"{result.get('launches')} launches")
            if not ok:
                failures.append(name)
                log("\n".join(f"  {line}" for line in lines[-40:]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        os.unlink(report_file)
    guards = results["guards"]
    log(f"phase 1 (g) in {time.time() - t0:.1f} s: {guards.get('covered')} of "
        f"{guards.get('library')} kernels covered"
        + (f", not launched: {guards.get('missing')}"
           if guards.get("missing") else "")
        + f"; sanitizer errors {errors}")
    if failures:
        raise AssertionError("phase 1: the kernel sweep failed: "
                             + ", ".join(failures))


def cold_ms(fn, sets, iters: int = 20) -> float:
    """Device ms per call of ``fn(*inputs)``, rotating over ``sets`` of
    inputs that hold more than COLD_BYTES together, so each call finds its
    inputs cold in the 50 MB L2. One call per set is captured in a CUDA
    graph and the graph is replayed ``iters`` times between two events: the
    time is the device's, without the host's launch overhead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (and build) off the capture
        for x in sets:
            fn(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in sets:
            fn(*x)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * len(sets))


def n_cold_sets(set_bytes: int) -> int:
    return COLD_BYTES // set_bytes + 1


def timed(kernel, plain, library, sets, nbytes, flops,
          flop_rate=H100_TF32X3_FLOP_PER_S):
    """(kernel, plain, library ms cold in L2, bound ms, bound_by, kernel ms
    hot in L2 as PR 2 timed it) for three functions of the same inputs."""
    ms, plain_ms, lib_ms = (cold_ms(fn, sets) for fn in (kernel, plain, library))
    hot = cuda_ms(lambda: kernel(*sets[0]))
    return (ms, plain_ms, lib_ms) + bound(nbytes, flops, flop_rate) + (hot,)


def log_timing(name, shape, r):
    ms, plain_ms, lib_ms, bound_ms, bound_by, hot = r
    log(f"{name} at {shape}, inputs cold in L2: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}): kernel at {100 * bound_ms / ms:.1f}% of its bound, "
        f"sdpa at {100 * bound_ms / lib_ms:.1f}%; kernel hot in L2 (PR 2's "
        f"timing, host launches) {hot:.4f} ms")


def time_kernel(att, shape, dtype_name="float32"):
    """Kernel, plain and SDPA times (ms) at one (rows, L, heads, dh,
    segment-bias) shape in fp32 or bf16 inputs, plus the card's bound for
    that work: bytes (q, k, v and the output in the input type, the fp32
    bias) or products (3xTF32 for fp32, the bf16 tensor cores' dense rate
    for bf16). SDPA gets
    the bias in the input type, as it requires."""
    import torch
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    B, L, H, dh, bias_2d = shape
    one = make_inputs(B, L, H, dh, dtype, bias_2d, 7)
    nbytes = 4 * one[0].numel() * one[0].element_size() + one[3].numel() * 4
    sets = [one] + [make_inputs(B, L, H, dh, dtype, bias_2d, 7 + i)
                    for i in range(1, n_cold_sets(nbytes))]

    def sdpa(q, k, v, bias):
        qh, kh, vh = (t.view(B, L, H, dh).transpose(1, 2) for t in (q, k, v))
        mask = bias[:, None] if bias_2d else bias[:, None, None, :]
        return F.scaled_dot_product_attention(qh, kh, vh,
                                              attn_mask=mask.to(dtype))

    rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
        H100_TF32X3_FLOP_PER_S
    return timed(lambda *x: att.attention_rows_cuda(*x, H),
                 lambda *x: att.attention_rows_plain(*x, H), sdpa, sets,
                 nbytes, 4 * B * H * L * L * dh, rate)


def build_engine(attention_impl, params=None, device=None, graphs=True,
                 **opts):
    """The flagship serving engine on the card, or on ``device``
    (``opts``: more conf keys); ``graphs=False``: the eager engine."""
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
        preprocess_od_name="OD_bottom-up", **opts,
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
    return InferenceEngine(cfg, spec, params, vocab, tok, device=device,
                           graphs=graphs), params


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
    device work (H2D + forward + score fetch, through the engine's eval
    step: graph replays on a graph engine), then profile the device part:
    device-busy share of its wall time and the kernels that take the most
    device time."""
    import torch

    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        batches = [b for _, _, b in engine._collated_batches(reqs)]
        host.append(time.perf_counter() - t0)

    def device_pass():
        for q, ocr, od, _gt, _extra in batches:
            engine._forward([engine.to_device(b) for b in (q, ocr, od)]).cpu()

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
        f"{engine.batch_size} ({engine.graph_count} CUDA graphs)")
    profile_device(device_pass, "serving pass")


def batch_scores(engine, reqs, batches=None):
    """The model's scores, one tensor per batch, on ``reqs`` collated by
    the engine or on ``batches`` of (q, ocr, od) host blocks."""
    import torch

    if batches is None:
        batches = [b[:3] for _, _, b in engine._collated_batches(reqs)]
    out = []
    for q, ocr, od in batches:
        with torch.inference_mode():
            out.append(engine.model(*(engine.to_device(b) for b in (q, ocr, od))))
    return out


def max_diff(a, b) -> float:
    """Largest |a - b| over two lists of tensors."""
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def serial_predict(engine, reqs):
    """The engine's batches one after the other: collate, move, run, fetch
    and decode each before the next starts (the pre-pipeline path)."""
    out = []
    for _, n_real, (q, ocr, od, _gt, extra) in engine._collated_batches(reqs):
        scores = engine._forward([engine.to_device(b) for b in (q, ocr, od)])
        out += engine._decode(scores, ocr["num"], extra, n_real)
    return out


def timed_qps(fn, n=N_REQUESTS):
    """(fn's result, requests per second): host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, n / (time.perf_counter() - t0)


def block_signature(blocks):
    """(key, shape, dtype) of every tensor of the model's (q, ocr, od)."""
    return tuple(tuple((k, tuple(v.shape), str(v.dtype))
                       for k, v in sorted(b.items())) for b in blocks)


def compare_answers(label, got, want, tol=SCORE_TOL, phase="phase 8"):
    """Equal answers and idx, scores within ``tol``; returns the max score
    difference."""
    diff = max(abs(a["score"] - b["score"]) for a, b in zip(got, want))
    ok = (len(got) == len(want)
          and [r["answer"] for r in got] == [r["answer"] for r in want]
          and [r["idx"] for r in got] == [r["idx"] for r in want]
          and diff <= tol)
    log(f"  {label}: {len(got)} answers, max |score diff| {diff:.3e} "
        f"(tol {tol:g}){'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {label} disagrees")
    return diff


def in_turns(ref_name, ref, name, fn):
    """Three rounds of ``ref`` and ``fn`` (no arguments), the order flipped
    each round. Returns ({name: [q/s]}, the last result of each) and logs
    the q/s with their medians."""
    qps, out = {ref_name: [], name: []}, {}
    for i in range(3):
        for arm in ((ref_name, name) if i % 2 == 0 else (name, ref_name)):
            out[arm], r = timed_qps(ref if arm == ref_name else fn)
            qps[arm].append(r)
    log("  in turns: " + "; ".join(
        f"{arm} {[round(x, 2) for x in v]} q/s (median "
        f"{statistics.median(v):.2f})" for arm, v in qps.items()))
    return qps, out


def encoder_bytes(engine) -> int:
    return sum(t.numel() * t.element_size()
               for t in engine.model.Bert.state_dict().values())


def serve_stack(params, reqs, phase2, drive):
    """Phase 8 (a)-(e): the serving stack at the flagship width on the
    engine of phase 2. ``drive(label, fn, batches)`` runs one path with the
    launch counts set to 0 and checks its K1 launches."""
    from ruart_tpu_torch.serve import BatchingServer

    n_batches = -(-N_REQUESTS // 16)
    engine, _ = build_engine("auto", params)

    # (a) the pipelined predict against the serial path
    log("phase 8 (a): pipelined predict against the serial path")
    _, out = in_turns("serial", lambda: serial_predict(engine, reqs),
                      "pipelined", lambda: drive(
                          "pipelined predict", lambda: engine.predict(reqs),
                          n_batches))
    piped = out["pipelined"]
    compare_answers("(a) pipelined vs phase 2", piped, phase2)
    compare_answers("(a) pipelined vs serial", piped, out["serial"])

    # (b) warmup: first pass of a fresh engine without, then with it; eager
    # engines, whose forward hook sees every batch (phase 12 b: graphs)
    fresh, _ = build_engine("auto", params, graphs=False)
    _, cold_qps = drive("first pass, no warmup",
                        lambda: timed_qps(lambda: fresh.predict(reqs)), n_batches)
    del fresh
    warm, _ = build_engine("auto", params, graphs=False)
    sigs = []
    hook = warm.model.register_forward_pre_hook(
        lambda _m, args: sigs.append(block_signature(args)))
    t0 = time.perf_counter()
    n_cal = drive("warmup_calibrated", lambda: warm.warmup_calibrated(reqs),
                  lambda n: n)
    cal_s = time.perf_counter() - t0
    warmed, n_warmed = set(sigs), len(sigs)
    del sigs[:]
    _, warm_qps = drive("first pass after warmup_calibrated",
                        lambda: timed_qps(lambda: warm.predict(reqs)), n_batches)
    live = set(sigs)
    hook.remove()
    t0 = time.perf_counter()
    n_full = drive("warmup(max_programs=32)",
                   lambda: warm.warmup(max_programs=32), lambda n: n)
    full_s = time.perf_counter() - t0
    log(f"phase 8 (b): warmup_calibrated ran {n_cal} signatures in "
        f"{cal_s:.3f} s, warmup(max_programs=32) {n_full} in {full_s:.3f} s; "
        f"first pass of a fresh engine {cold_qps:.2f} q/s without warmup, "
        f"{warm_qps:.2f} q/s after warmup_calibrated; {len(live)} live "
        f"signatures, all among the {len(warmed)} warmed: {live <= warmed}")
    if not (n_cal == n_warmed == len(warmed) and live and live <= warmed):
        raise AssertionError("phase 8: a live signature was not warmed")
    del warm

    # (c) BatchingServer: a burst of the 40 requests on the server's new
    # threads, the same burst again, then a lone request
    submit_ms = []
    with BatchingServer(engine, max_wait_ms=10) as server:
        def burst():
            t0 = time.perf_counter()
            futs = [server.submit(r) for r in reqs]
            submit_ms.append((time.perf_counter() - t0) * 1e3)
            return [f.result(timeout=300) for f in futs]

        bursts = []
        for i in range(2):
            served, burst_qps = drive(f"BatchingServer burst {i + 1}",
                                      lambda: timed_qps(burst), n_batches)
            compare_answers(f"(c) BatchingServer burst {i + 1} vs predict",
                            served, piped)
            bursts.append((burst_qps, server.stats()))
        t0 = time.perf_counter()
        lone = drive("BatchingServer lone request",
                     lambda: server.predict_one(reqs[0], timeout=300), 1)
        lone_ms = (time.perf_counter() - t0) * 1e3
        stats = server.stats()
    log(f"phase 8 (c): BatchingServer(max_wait_ms=10) burst 1 "
        f"{bursts[0][0]:.2f} q/s, stats {json.dumps(bursts[0][1])}; burst 2 "
        f"{bursts[1][0]:.2f} q/s; lone request {lone_ms:.2f} ms "
        f"({lone['answer']!r}); stats over all {json.dumps(stats)}")
    log_wave_margin("8 (c)", submit_ms, server)
    if stats["batches"] != 2 * n_batches + 1:
        raise AssertionError(f"phase 8: the server ran {stats['batches']} "
                             f"waves, expected {2 * n_batches + 1}")

    # (d) the num_worker pool on the card: byte-equal batches, equal answers
    with build_engine("auto", params, num_worker=2)[0] as pooled:
        got = list(pooled._collated_batches(reqs))
        want = list(engine._collated_batches(reqs))
        for (s1, n1, a), (s2, n2, b) in zip(got, want):
            same = (s1, n1) == (s2, n2) and a[4] == b[4] and all(
                list(x) == list(y) and all(
                    x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
                    for k in x)
                for x, y in zip(a[:3], b[:3]))
            if not same:
                raise AssertionError("phase 8: pooled batches differ from serial")
        log(f"phase 8 (d): {len(got)} pooled batches byte-equal to serial; "
            f"num_worker 2 against num_worker 0")
        _, out = in_turns("num_worker 0", lambda: engine.predict(reqs),
                          "num_worker 2", lambda: drive(
                              "num_worker 2 predict",
                              lambda: pooled.predict(reqs), n_batches))
    compare_answers("(d) num_worker 2 vs serial", out["num_worker 2"], piped)

    # (e) INT8_BERT: kernel against plain on the int8 encoder
    fp32_bytes = encoder_bytes(engine)
    int8 = build_engine("auto", params)[0].quantize()
    int8_plain = build_engine("plain", params)[0].quantize()
    diff = max_diff(batch_scores(int8, reqs), batch_scores(int8_plain, reqs))
    del int8_plain
    log("phase 8 (e): int8 against fp32")
    _, out = in_turns("fp32", lambda: engine.predict(reqs), "int8",
                      lambda: drive("int8 predict", lambda: int8.predict(reqs),
                                    n_batches))
    agree = sum(a["answer"] == b["answer"] for a, b in zip(out["int8"], piped))
    log(f"phase 8 (e): int8 kernel vs int8 plain max |score diff| "
        f"{diff:.3e} (tol {SCORE_TOL:g}); answers agree with fp32 on "
        f"{agree}/{N_REQUESTS}; encoder weights "
        f"{fp32_bytes} bytes fp32, {encoder_bytes(int8)} int8")
    if not diff <= SCORE_TOL:
        raise AssertionError("phase 8: the int8 kernel path and the int8 "
                             "plain path disagree")


def log_wave_margin(label, submit_ms, server):
    """A burst forms full waves only if the gather thread finds its
    requests queued within ``max_wait_ms`` of the first: the wave count
    depends on the time the burst takes to submit. Prints that margin."""
    limit = server.max_wait_s * 1e3
    log(f"phase {label}: bursts submitted in "
        f"{[round(x, 3) for x in submit_ms]} ms; margin of the wave count "
        f"(value / limit, max_wait_ms {limit:g}) "
        f"{max(submit_ms) / limit:.3f}")


def serve_clis(folder, conf_predict, reqs, drive):
    """Phase 8 (f): ``cli.serve_main`` (fp32 and INT8_BERT) and
    ``cli.main_test`` under INT8_BERT from phase 6's best checkpoint."""
    import io

    from ruart_tpu_torch.cli import main as cli_main
    from ruart_tpu_torch.cli import main_test as cli_main_test
    from ruart_tpu_torch.cli import serve_main

    n_batches = -(-N_REQUESTS // 16)
    with open(conf_predict) as f:
        body = f.read()
    conf_int8 = conf_predict + "_int8"
    with open(conf_int8, "w") as f:
        f.write("INT8_BERT\n" + body)
    ref = serve_main.build_engine(cli_main.build_config(conf_predict))
    want = {"fp32": ref.predict(reqs)}
    want["INT8_BERT"] = ref.quantize().predict(reqs)
    del ref
    lines = "".join(json.dumps(r) + "\n" for r in reqs)
    for mode, conf in (("fp32", conf_predict), ("INT8_BERT", conf_int8)):
        stdio = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = io.StringIO(lines), io.StringIO()
        try:
            t0 = time.perf_counter()
            n = drive(f"serve_main {mode}", lambda: serve_main.main(
                ["--conf_file", conf, "--warmup", "8"]), n_batches)
            wall = time.perf_counter() - t0
            out = sys.stdout.getvalue()
        finally:
            sys.stdin, sys.stdout = stdio
        got = [json.loads(line) for line in out.splitlines()]
        log(f"phase 8 (f): serve_main {mode} --warmup 8 served {n} requests "
            f"in {wall:.2f} s (engine build and warmup included)")
        if not n == len(got) == N_REQUESTS:
            raise AssertionError(f"phase 8: serve_main wrote {len(got)} lines")
        compare_answers(f"(f) serve_main {mode} vs an engine from the "
                        f"checkpoint", got, want[mode])
    drive("main_test INT8_BERT",
          lambda: cli_main_test.main(["--conf_file", conf_int8]), n_batches)
    with open(os.path.join(folder, "submission.json")) as f:
        sub = json.load(f)
    log(f"phase 8 (f): main_test INT8_BERT wrote {len(sub)} entries")
    if len(sub) != N_TEST or not all(isinstance(r["answer"], str) for r in sub):
        raise AssertionError("phase 8: the INT8_BERT submission is wrong")


def bound(nbytes: float, flops: float, flop_rate=H100_TF32X3_FLOP_PER_S):
    """The least time (ms) the card could take: the larger of the bytes
    over its memory rate and the operations over ``flop_rate`` (by
    default the fastest fp32-accurate rate it has, 3xTF32 on the tensor
    cores)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_inputs(B, H, L, D, dtype, seed, on_grid=True):
    """Head-major q, k ~ N(0, 0.25), on a 1/16 grid (exact scores) when
    ``on_grid``, v ~ N(0, 0.25), and a [B, 1, 1, L] key bias: ~20% of keys
    masked at random, key 0 kept, and the last fifth of the keys masked for
    every row (an all-masked tail). Every query keeps key 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def grid():
        x = torch.randn(B, H, L, D, generator=g, device="cuda") * 0.5
        return (torch.round(x * 16) / 16 if on_grid else x).to(dtype)

    q, k = grid(), grid()
    v = (torch.randn(B, H, L, D, generator=g, device="cuda") * 0.5).to(dtype)
    keep = torch.rand(B, L, generator=g, device="cuda") > 0.2
    keep[:, L - max(1, L // 5):] = False
    keep[:, 0] = True
    bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    return q, k, v, bias.contiguous()


def check_flash(att):
    """Phase 4: K3 against its plain version. Returns the worst fp32 error."""
    import torch

    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = [(shape, dtype, True) for shape in FLASH_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    # off the grid (not exact in TF32): catches a kernel without the split
    cases.append((FLASH_SHAPES[0], torch.float32, False))
    # rows 65 elements apart: not 16-byte aligned, staged element by element
    cases += [((2, 3, 65, 64), dtype, None)
              for dtype in (torch.float32, torch.bfloat16)]
    for i, ((B, H, L, D), dtype, on_grid) in enumerate(cases):
        q, k, v, bias = flash_inputs(B, H, L, D, dtype, 20 + i,
                                     on_grid is not False)
        if on_grid is None:
            q, k, v = (padded_rows(x) for x in (q, k, v))
        got = att.flash_attention_cuda(q, k, v, bias)
        torch.cuda.synchronize()
        want = att.flash_attention_plain(q, k, v, bias)
        name = str(dtype).split(".")[-1]
        err = (got - want).abs().max().item()
        ok = (got.dtype == torch.float32 and math.isfinite(err)
              and err <= TOL[name])
        log(f"flash check [B,H,L,D]=({B},{H},{L},{D}) {name} in"
            f"{' off-grid' if on_grid is False else ''}"
            f"{' unaligned' if on_grid is None else ''}, "
            f"{str(got.dtype).split('.')[-1]} out: max |kernel - plain| = "
            f"{err:.3e} (tol {TOL[name]:g}){'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError("flash attention kernel disagrees with "
                                 "its plain version")
        worst[name] = max(worst[name], err)
    return worst["float32"]


def time_flash(att):
    """K3, plain and SDPA times (ms) at FLASH_SHAPES[0], plus the bound."""
    import torch
    import torch.nn.functional as F

    B, H, L, D = FLASH_SHAPES[0]
    nbytes = 4 * B * H * L * D * 4 + B * L * 4
    sets = [flash_inputs(B, H, L, D, torch.float32, 30 + i)
            for i in range(n_cold_sets(nbytes))]

    def sdpa(q, k, v, bias):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    return timed(att.flash_attention_cuda, att.flash_attention_plain, sdpa,
                 sets, nbytes, 4 * B * H * L * L * D)


def ptxas_report(report: str):
    """One line per kernel of nvcc's ``-Xptxas -v`` report: registers,
    spills and shared memory, under the demangled name when c++filt is
    there."""
    kernels, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            kernels.append([name, ""])
        elif kernels and ("spill" in line or "registers" in line):
            kernels[-1][1] += " " + line.split(":", 1)[-1].strip()
    names = [n for n, _ in kernels]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pass
    for shown, (_, props) in zip(names, kernels):
        shown = shown.replace("(anonymous namespace)::", "").split("(")[0]
        log(f"  ptxas: {shown}:{props}")


def check_autograd(att):
    """Phase 5: the autograd.Function against the plain version under
    autograd at the serving shape. Returns the worst abs error."""
    import torch

    B, L, H, dh, _ = SERVE_SHAPE
    q, k, v, bias = make_inputs(B, L, H, dh, torch.float32, True, 40)
    w = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(41),
                    device="cuda")
    worst = 0.0
    outs, grads = [], []
    for fn in (att.fused_attention, att.attention_rows_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, bias, H)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    worst = max([(outs[0] - outs[1]).abs().max().item()] + [
        (a - b).abs().max().item() for a, b in zip(*grads)])
    log(f"phase 5: autograd.Function vs plain autograd at {SERVE_SHAPE}: "
        f"max |diff| over output and q/k/v grads = {worst:.3e} (tol {GRAD_TOL:g})")
    if not worst <= GRAD_TOL:
        raise AssertionError("attention autograd.Function disagrees with the "
                             "plain version's gradient")
    return worst


# -- G1: the encoder's fp32 Linears (csrc/gemm_tf32x3.cu) -----------------

# (M, N, K, weights, gelu, bias): the Linears of one encoder layer at the
# benchmark cells' token counts (the training cell's 4,352 packed tokens,
# the offline cell's 7,936 and 14,592), ragged M, the tp 2 shards (Q/K/V
# and intermediate_dense column-parallel, the other two row-parallel,
# without bias)
G1_LAYER = ((768, 768, 3, False, True), (768, 768, 1, False, True),
            (3072, 768, 1, True, True), (768, 3072, 1, False, True))
G1_TOKENS = (4352, 7936, 14592)
G1_CASES = (
    [(m, *c) for m in G1_TOKENS for c in G1_LAYER]
    + [(1, 768, 768, 3, False, True), (77, 768, 768, 1, False, True),
       (1000, 3072, 768, 1, True, True), (4353, 768, 3072, 1, False, True)]
    + [(1000, 384, 768, 3, False, True), (1000, 1536, 768, 1, True, True),
       (1000, 768, 384, 1, False, False), (1000, 768, 1536, 1, False, False)])
G1_ERR_RATIO = 2.0   # G1's worst error against fp64 over cuBLAS FFMA's,
                     # each the worst over G1_CASES
G1_EDGE_TOL = 1e-5   # the same error at the edges of the tile


def gemm_inputs(M, N, K, n, bias, seed):
    """x ~ N(0, 1) [M, K]; n weights ~ N(0, 0.02) [N, K] and biases ~ N(0,
    0.02) (or None), as BERT's initializer draws them: off any grid."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    x = draw(M, K)
    ws = [draw(N, K, std=0.02) for _ in range(n)]
    bs = [draw(N, std=0.02) if bias else None for _ in range(n)]
    return x, ws, bs


def gemm_error(y, x, w, b, gelu) -> float:
    """max |y - Y| / (|x| |w|^T + |b|) with Y the fp64 product (gelu'd when
    ``gelu``): the error of each output over the scale of its sum."""
    import torch.nn.functional as F

    xd, wd = x.double(), w.double()
    bd = None if b is None else b.double()
    ref = F.linear(xd, wd, bd)
    if gelu:
        ref = F.gelu(ref)
    scale = F.linear(xd.abs(), wd.abs(), None if bd is None else bd.abs())
    return ((y.double() - ref).abs() / scale).max().item()


def check_gemm(gemm):
    """G1 against fp64 and cuBLAS's FFMA SGEMM (``F.linear``, TF32 off) on
    the same inputs, the edges of its tile, a captured and replayed launch,
    the autograd path and the inputs it refuses. Returns (G1's worst error
    over FFMA's, G1's worst error, worst |G1 - F.linear|)."""
    import torch
    import torch.nn.functional as F

    assert not torch.backends.cuda.matmul.allow_tf32
    worst_err = worst_ffma = worst_diff = 0.0
    for i, (M, N, K, n, gelu, bias) in enumerate(G1_CASES):
        x, ws, bs = gemm_inputs(M, N, K, n, bias, 100 + i)
        before = gemm.linear_cuda.launches
        ys = gemm.linear_many(x, ws, bs, gelu)
        torch.cuda.synchronize()
        if gemm.linear_cuda.launches - before != 1:
            raise AssertionError(f"G1 at {(M, N, K, n)}: "
                                 f"{gemm.linear_cuda.launches - before} "
                                 "launches, expected 1")
        err = ffma = diff = 0.0
        for y, w, b in zip(ys, ws, bs):
            lib = gemm.linear_plain(x, w, b, gelu)
            err = max(err, gemm_error(y, x, w, b, gelu))
            ffma = max(ffma, gemm_error(lib, x, w, b, gelu))
            diff = max(diff, (y - lib).abs().max().item())
        worst_err, worst_ffma = max(worst_err, err), max(worst_ffma, ffma)
        worst_diff = max(worst_diff, diff)
        log(f"  G1 {(M, N, K)} x{n}{' gelu' if gelu else ''}"
            f"{'' if bias else ' no bias'}: error {err:.3e}, FFMA {ffma:.3e} ({err / ffma:.2f} x), max "
            f"|G1 - F.linear| {diff:.3e}")
    ratio = worst_err / worst_ffma
    if not ratio <= G1_ERR_RATIO:
        raise AssertionError(f"G1's worst error {worst_err:.3e} is over "
                             f"{G1_ERR_RATIO} x FFMA's {worst_ffma:.3e}")
    # the edges of the tile: one row, a ragged second tile, one stage of K
    for i, (M, N, K) in enumerate(((1, 128, 64), (130, 256, 128),
                                   (130, 128, 32))):
        x, ws, bs = gemm_inputs(M, N, K, 2, True, 200 + i)
        ys = gemm.linear_cuda(x, ws, bs, True)
        err = max(gemm_error(y, x, w, b, True) for y, w, b in zip(ys, ws, bs))
        log(f"  G1 at {(M, N, K)} x2 gelu: error {err:.3e} "
            f"(tol {G1_EDGE_TOL:g})")
        if not err <= G1_EDGE_TOL:
            raise AssertionError(f"G1 at {(M, N, K)}: error {err:.3e}")
    # a launch captured in a CUDA graph, replayed on new inputs
    x, ws, bs = gemm_inputs(4352, 768, 768, 3, True, 300)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gemm.linear_many(x, ws, bs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gemm.linear_many(x, ws, bs)
    x.copy_(gemm_inputs(4352, 768, 768, 1, False, 301)[0])
    graph.replay()
    eager = gemm.linear_many(x, ws, bs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(captured, eager)):
        raise AssertionError("G1: a graph replay differs from the eager launch")
    del graph
    # the autograd path (LOCK_BERT off): kernel forward, plain backward
    x, [w], [b] = gemm_inputs(1000, 768, 3072, 1, True, 400)
    r = torch.randn(1000, 768, device="cuda")
    grads = []
    for fn in (gemm.linear, F.linear):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        (fn(*leaves) * r).sum().backward()
        grads.append([t.grad for t in leaves])
    gdiff = max(((a - c).abs().max() / c.abs().max()).item()
                for a, c in zip(*grads))
    log(f"  G1 autograd at (1000, 768, 3072): max |grad - F.linear's| over "
        f"its largest {gdiff:.3e} (tol {G1_EDGE_TOL:g})")
    if not gdiff <= G1_EDGE_TOL:
        raise AssertionError("G1's autograd path disagrees with F.linear's")
    # what it refuses
    x, [w], [b] = gemm_inputs(64, 128, 128, 1, True, 500)
    for label, args in (
            ("bf16", (x.bfloat16(), [w.bfloat16()], [b.bfloat16()])),
            ("non-contiguous x", (x.t(), [w], [b])),
            ("K 100", (x[:, :100].contiguous(), [w[:, :100].contiguous()],
                       [b])),
            ("N 100", (x, [w[:100].contiguous()], [b[:100].contiguous()])),
            ("CPU weight", (x, [w.cpu()], [b]))):
        try:
            gemm.linear_cuda(*args)
        except ValueError:
            continue
        raise AssertionError(f"G1 took {label}")
    log(f"phase 1 (h) ok: G1 worst error {worst_err:.3e}, FFMA's "
        f"{worst_ffma:.3e} ({ratio:.2f} x, limit {G1_ERR_RATIO}), worst "
        f"|G1 - F.linear| {worst_diff:.3e}")
    return ratio, worst_err, worst_diff


def time_gemm(gemm, M=G1_TOKENS[0]):
    """G1's launches of one encoder layer at M tokens (Q/K/V joined,
    attention output, intermediate with gelu, output), each timed hot in L2
    as the layer meets them, beside the plain version (F.linear, then the
    gelu), cuBLAS's FFMA F.linear (``library_ms``, a yardstick the port
    does not call) and the bound (2 M N K per product over 3xTF32's 165
    TFLOP/s). Returns the layer's sums as ``timed`` does."""
    import torch.nn.functional as F

    total = [0.0] * 4
    for i, (N, K, n, gelu, bias) in enumerate(G1_LAYER):
        x, ws, bs = gemm_inputs(M, N, K, n, bias, 600 + i)
        ms = cuda_ms(lambda: gemm.linear_cuda(x, ws, bs, gelu))
        plain = cuda_ms(lambda: [gemm.linear_plain(x, w, b, gelu)
                                 for w, b in zip(ws, bs)])
        lib = cuda_ms(lambda: [F.linear(x, w, b) for w, b in zip(ws, bs)])
        flops = 2.0 * M * N * K * n
        bound_ms = bound(4.0 * (M * K + n * (N * K + M * N)), flops)[0]
        log(f"  G1 at {(M, N, K)} x{n}{' gelu' if gelu else ''}: "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s), plain {plain:.4f} ms, FFMA F.linear {lib:.4f} ms "
            f"({flops / lib / 1e9:.1f} TFLOP/s); bound {bound_ms:.4f} ms: G1 "
            f"at {100 * bound_ms / ms:.1f}% of it")
        for j, v in enumerate((ms, plain, lib, bound_ms)):
            total[j] += v
    ms, plain, lib, bound_ms = total
    return (ms, plain, lib, bound_ms, "operations", ms)


# -- the Moonlight encoder's kernels (csrc/moe_bf16.cu, attention_bf16.cu) --

# (tokens, hidden, expert width, experts, top k): the training cell's 4,352
# packed tokens at the published widths, then small ragged ones
MOE_CASES = ((4352, 2048, 1408, 64, 6), (37, 128, 64, 8, 2),
             (1, 64, 64, 4, 3), (300, 256, 128, 16, 4))
# rows, L, heads, query/key width, value width: the training cell's packed
# rows of 32 at the published 16 heads of 192/128
MLA_SHAPE = (136, 32, 16, 192, 128)
MLA_LENGTHS = (1, 16, 31, 32, 33, 64, 65, 512)


def moe_inputs(T, D, W, E, k, seed, skew):
    """bf16 tokens N(0, 1), fp32 router logits of a random N(0, 0.02)
    router, a bf16 correction bias N(0, 0.05), stacked bf16 expert weights
    N(0, 0.02); with ``skew`` a quarter of the experts get no rows and one
    expert most of them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)

    x = draw(T, D)
    logits = x.float() @ draw(E, D, std=0.02, dtype=torch.float32).T
    if skew:
        logits[:, : max(1, E // 4)] = -30.0
        logits[:, E - 1] += 3.0
    bias = draw(E, std=0.05)
    return (x, logits, bias, draw(E, 2 * W, D, std=0.02),
            draw(E, D, W, std=0.02), draw(T, D), draw(T, D))


def check_moonlight(att, moe):
    """The expert layer's kernels against their plain twins (on the same
    inputs, on the card) at MOE_CASES, straight and skewed (experts with no
    rows, one with most): the same experts and row counts, weights within
    1e-6, the permutation consistent, each grouped product and the combine
    within 1e-2 of the output's scale (bf16 outputs; the plain twin rounds
    cuBLAS's sums), the routed-row counter; the layer replayed from a CUDA
    graph byte-equal to its eager run. Then the 192/128 attention against
    attention_rows_plain at MLA_LENGTHS, both bias forms (2e-2, as K1
    bf16). Returns (worst MoE error over its scale, worst attention
    error)."""
    import torch

    worst = 0.0
    for i, (T, D, W, E, k) in enumerate(MOE_CASES):
        for skew in (False, True):
            x, logits, bias, wgu, wd, shared, res = moe_inputs(
                T, D, W, E, k, 100 + i, skew)
            load = torch.zeros(E, dtype=torch.int64, device="cuda")
            idx, w, counts = moe.route_cuda(logits, bias, k, 2.446, load)
            pidx, pw, pcounts = moe.route_plain(logits, bias, k, 2.446)
            same = torch.equal(idx.sort(-1).values, pidx.sort(-1).values)
            order_k, order_p = idx.sort(-1).indices, pidx.sort(-1).indices
            werr = (w.gather(1, order_k) - pw.gather(1, order_p)).abs().max()
            if not (same and torch.equal(counts, pcounts)
                    and torch.equal(load, pcounts.long())
                    and werr <= 1e-6 * 2.446):
                raise AssertionError(f"phase 1 (i): route at {(T, D, E, k)} "
                                     f"skew {skew}: experts same {same}, "
                                     f"weight error {float(werr):.3e}")
            offsets, rows, slot_pos = moe.permute_cuda(idx, counts)
            want_off = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
            ok = torch.equal(offsets, want_off.int()) and torch.equal(
                rows[slot_pos.long()].long(),
                torch.arange(T, device="cuda").repeat_interleave(k))
            e_of = torch.repeat_interleave(torch.arange(E, device="cuda"),
                                           counts.long())
            ok = ok and torch.equal(e_of, idx.reshape(-1)[
                slot_pos.argsort().long()].long())
            if not ok:
                raise AssertionError(f"phase 1 (i): permute at {(T, E, k)} "
                                     f"skew {skew} is inconsistent")
            h = moe.grouped_gemm_cuda(x, rows, wgu, offsets, True)
            errs = [(h, moe.grouped_gemm_plain(x, rows, wgu, offsets, True))]
            y = moe.grouped_gemm_cuda(h, None, wd, offsets, False)
            errs.append((y, moe.grouped_gemm_plain(h, None, wd, offsets,
                                                   False)))
            out = moe.combine_cuda(y, slot_pos, w, shared, res)
            errs.append((out, moe.combine_plain(y, slot_pos, w, shared, res)))
            for j, (got, want) in enumerate(errs):
                scale = want.float().abs().max().clamp(min=1e-30)
                err = float((got.float() - want.float()).abs().max() / scale)
                worst = max(worst, err)
                if not err <= 1e-2:
                    raise AssertionError(
                        f"phase 1 (i): {('gate/up', 'down', 'combine')[j]} at "
                        f"{(T, D, W, E, k)} skew {skew}: error {err:.3e} of "
                        f"the scale")
            log(f"phase 1 (i): experts at {(T, D, W, E, k)} skew {skew}: "
                f"rows per expert {int(counts.min())}-{int(counts.max())}, "
                f"errors within {worst:.2e} of the scale")
    # the layer inside a CUDA graph: replayed on new inputs = eager
    T, D, W, E, k = MOE_CASES[0]
    x, logits, bias, wgu, wd, shared, res = moe_inputs(T, D, W, E, k, 7, False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.experts(x, logits, bias, k, 2.446, wgu, wd, shared, res)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = moe.experts(x, logits, bias, k, 2.446, wgu, wd, shared, res)
    x2, logits2, *_ = moe_inputs(T, D, W, E, k, 8, True)
    x.copy_(x2)
    logits.copy_(logits2)
    graph.replay()
    torch.cuda.synchronize()
    want, _ = moe.experts(x, logits, bias, k, 2.446, wgu, wd, shared, res)
    if not torch.equal(got, want):
        raise AssertionError("phase 1 (i): the expert layer replayed from a "
                             "graph differs from its eager run")
    del graph
    # the latent attention's widths
    R, L0, H, dq, dv = MLA_SHAPE
    aworst = 0.0
    for L in MLA_LENGTHS:
        for bias_2d in (True, False):
            B = 2 if L == 512 else 3
            q, kk, _, b = make_inputs(B, L, H, dq, torch.bfloat16, bias_2d,
                                      L + 31 * bias_2d)
            v = make_inputs(B, L, H, dv, torch.bfloat16, bias_2d, L + 7)[2]
            scale = dq ** -0.5
            got = att.attention_rows_cuda(q, kk, v, b, H, scale=scale)
            want = att.attention_rows_plain(q, kk, v, b, H, scale=scale)
            err = float((got.float() - want.float()).abs().max())
            aworst = max(aworst, err)
            if not err <= TOL["bfloat16"]:
                raise AssertionError(f"phase 1 (i): 192/128 attention at L "
                                     f"{L} bias_2d {bias_2d}: error {err:.3e}")
    log(f"phase 1 (i) ok: expert kernels within {worst:.2e} of the scale, "
        f"192/128 attention within {aworst:.2e}; the layer replays from a "
        "graph byte-equal")
    return worst, aworst


def time_moonlight(att, moe):
    """Device ms (graph replays, inputs hot in L2 as the layer finds them)
    at the training cell's shapes: the grouped gate/up and down products of
    one layer beside their bound (max(bytes / 3.35 TB/s, FLOPs / 989
    TFLOP/s): every expert's weights and the rows read once, the output
    written once) and the plain twin (cuBLAS per expert, host loop); route,
    permute and combine; the 192/128 attention at MLA_SHAPE beside its
    bound and its plain version."""
    import torch

    T, D, W, E, k = MOE_CASES[0]
    x, logits, bias, wgu, wd, shared, res = moe_inputs(T, D, W, E, k, 9, False)
    idx, w, counts = moe.route_cuda(logits, bias, k, 2.446)
    offsets, rows, slot_pos = moe.permute_cuda(idx, counts)
    h = moe.grouped_gemm_cuda(x, rows, wgu, offsets, True)
    y = moe.grouped_gemm_cuda(h, None, wd, offsets, False)
    M = T * k
    out = {}

    def graph_ms(fn, iters=20):
        return cold_ms(lambda: fn(), [()], iters)

    out["gate_up"] = graph_ms(lambda: moe.grouped_gemm_cuda(
        x, rows, wgu, offsets, True))
    out["down"] = graph_ms(lambda: moe.grouped_gemm_cuda(
        h, None, wd, offsets, False))
    out["route"] = graph_ms(lambda: moe.route_cuda(logits, bias, k, 2.446))
    out["permute"] = graph_ms(lambda: moe.permute_cuda(idx, counts))
    out["combine"] = graph_ms(lambda: moe.combine_cuda(y, slot_pos, w,
                                                       shared, res))
    plain = cuda_ms(lambda: moe.grouped_gemm_plain(x, rows, wgu, offsets,
                                                   True), iters=5, warmup=1)
    plain += cuda_ms(lambda: moe.grouped_gemm_plain(h, None, wd, offsets,
                                                    False), iters=5, warmup=1)
    flops = 2.0 * M * (2 * W) * D + 2.0 * M * D * W
    nbytes = 2.0 * (E * 2 * W * D + M * D + M * W) + 2.0 * (
        E * D * W + M * W + M * D)
    bound_ms = 1e3 * max(nbytes / H100_BYTES_PER_S,
                         flops / H100_BF16_FLOP_PER_S)
    gemm_ms = out["gate_up"] + out["down"]
    log(f"phase 1 (i): one expert layer at {T} tokens x top {k} of {E}: "
        f"grouped gate/up {out['gate_up']:.4f} ms, down {out['down']:.4f} ms "
        f"({flops / gemm_ms / 1e9:.1f} TFLOP/s); bound {bound_ms:.4f} ms: "
        f"{100 * bound_ms / gemm_ms:.1f}% of it; plain twin {plain:.4f} ms; "
        f"route {out['route']:.4f}, permute {out['permute']:.4f}, combine "
        f"{out['combine']:.4f} ms")
    R, L, H, dq, dv = MLA_SHAPE
    q, kk, _, b = make_inputs(R, L, H, dq, torch.bfloat16, True, 5)
    v = make_inputs(R, L, H, dv, torch.bfloat16, True, 6)[2]
    scale = dq ** -0.5
    mla_ms = graph_ms(lambda: att.attention_rows_cuda(q, kk, v, b, H,
                                                      scale=scale))
    mla_plain = graph_ms(lambda: att.attention_rows_plain(q, kk, v, b, H,
                                                          scale=scale))
    mflops = 2.0 * R * L * L * H * (dq + dv)
    mbytes = 2.0 * R * L * H * (2 * dq + 2 * dv) + 4.0 * R * L * L
    mbound = 1e3 * max(mbytes / H100_BYTES_PER_S,
                       mflops / H100_BF16_FLOP_PER_S)
    log(f"phase 1 (i): 192/128 attention at {MLA_SHAPE}: kernel "
        f"{mla_ms:.4f} ms, plain {mla_plain:.4f} ms; bound {mbound:.4f} ms "
        f"(bytes): {100 * mbound / mla_ms:.1f}% of it")
    return dict(out, plain=plain, bound_ms=bound_ms, mla_ms=mla_ms,
                mla_plain=mla_plain, mla_bound=mbound)


def moonlight_evaluate():
    """RUArt over the Moonlight encoder at its published widths (the conf
    key ``LLM_ENCODER`` naming the published config.json, ``BF16``; seeded
    weights drawn on the card) through ``make_eval_step`` (one CUDA graph
    per signature) and ``evaluate`` on 48 synthetic items at batch 16:
    every score finite, a second pass (graph replays) giving the same
    answers and loss, the eager step a loss within 1e-5 (answers are not
    compared: with random weights the best score may change on rounding);
    the routed-row counter at top 6 of 64 in each of the 26 expert
    layers; each pass's launches of the encoder's kernels, set to 0 just
    before it and read just after, at their number per encoder call (one
    route, permute and combine and two grouped GEMMs per expert layer, one
    192/128 attention per layer) times the pass's encoder calls. Returns
    the graph pass's seconds and the launches of the three passes."""
    from ruart_tpu_torch.core.presets import stvqa_config

    with open(os.path.join(HERE, "portbench", "configs",
                           "moonlight-bf16.json")) as f:
        published = json.load(f)["bert"]
    # the conf names the config.json for its whole life (Config reads it
    # again wherever it derives its widths: the collator too)
    folder = tempfile.mkdtemp()
    try:
        path = os.path.join(folder, "config.json")
        with open(path, "w") as f:
            json.dump(published, f)
        moe_layers = (published["num_hidden_layers"]
                      - published["first_k_dense_replace"])
        per_call = {"route": moe_layers, "permute": moe_layers,
                    "grouped GEMM": 2 * moe_layers, "combine": moe_layers,
                    "192/128 attention": published["num_hidden_layers"]}
        return _moonlight_evaluate(stvqa_config(
            vocab_size=5000, batch_size=16,
            preprocess_ocr_name="ocr_PMTD_ASTER,ES_ocr",
            preprocess_od_name="OD_bottom-up", LLM_ENCODER=path, BF16=True),
            per_call)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def _moonlight_evaluate(cfg, per_call):
    import torch

    from ruart_tpu_torch.data.dataset import VQADataset
    from ruart_tpu_torch.data.preprocess import Preprocessor
    from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
    from ruart_tpu_torch.eval.evaluator import evaluate
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.ops import moe
    from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.train_step import make_eval_step
    from ruart_tpu_torch.utils.graphs import release

    spec = ModelSpec.from_config(cfg)
    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(48, seed=5, n_ocr_range=(15, 30),
                                     n_es=40)["data"]
    data = pre._process_data(raw)
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="dev",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    device = torch.device("cuda")
    with device:
        model = RUArtModel(spec)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    loss_fn = make_loss_fn("BCE_D1")
    counters = {"route": (moe.route_cuda, "launches"),
                "permute": (moe.permute_cuda, "launches"),
                "grouped GEMM": (moe.grouped_gemm_cuda, "launches"),
                "combine": (moe.combine_cuda, "launches"),
                "192/128 attention": (att.attention_rows_cuda,
                                      "wide_launches")}
    passes = []

    def counted(step):
        """One evaluate pass with the launch counts set to 0 just before
        and read just after."""
        for fn, name in counters.values():
            setattr(fn, name, 0)
        out = evaluate(step, ds, cfg, spec, device)
        torch.cuda.synchronize()
        passes.append({k: getattr(fn, name)
                       for k, (fn, name) in counters.items()})
        return out

    step = make_eval_step(model, loss_fn)
    first = counted(step)
    t0 = time.perf_counter()
    again = counted(step)
    seconds = time.perf_counter() - t0
    calls = []  # the eager pass's encoder calls (a graph replay runs no hook)
    hook = model.Bert.register_forward_pre_hook(lambda m, a: calls.append(1))
    eager = counted(make_eval_step(model, loss_fn, graphs=False))
    hook.remove()
    release(step)
    launches = {k: sum(p[k] for p in passes) for k in counters}
    n_batches = -(-first["n"] // cfg.batch_size)
    counts_ok = len(calls) >= n_batches and all(
        p == {k: n * len(calls) for k, n in per_call.items()} for p in passes)
    log(f"phase 1 (i): evaluate's launches per pass (graph capture pass, "
        f"graph replay pass, eager pass) over {len(calls)} encoder calls "
        f"({n_batches} batches): {passes}; per encoder call {per_call}")
    load = model.Bert.expert_load.sum(dim=1)
    answers = [r["answer"] for r in first["res"]]
    ok = (first["n"] == 48 and math.isfinite(first["loss"])
          and all(math.isfinite(r["score"]) for r in first["save_res"])
          and answers == [r["answer"] for r in again["res"]]
          and first["loss"] == again["loss"]
          and abs(first["loss"] - eager["loss"]) <= 1e-5 * abs(eager["loss"])
          and bool((load == load[0]).all()) and int(load[0]) % 6 == 0
          and load.numel() == 26 and counts_ok)
    log(f"phase 1 (i): evaluate over the Moonlight encoder at its published "
        f"widths: {first['n']} items, loss {first['loss']:.6f} (eager "
        f"{eager['loss']:.6f}), a graph pass in {seconds:.3f} s, "
        f"{int(load[0]) // 6} tokens routed per expert layer")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("phase 1 (i): evaluate over the Moonlight "
                             "encoder failed its checks")
    return seconds, launches, len(calls) * len(passes)


def _letters(n: int) -> str:
    out = ""
    for _ in range(4):
        n, r = divmod(n, 26)
        out += chr(97 + r)
    return "x" + out


def write_training_data(root: str) -> str:
    """Synthetic raw msgpack splits and a train conf (the shipped ST-VQA
    train conf's keys, batch 16, one epoch of 20 steps) under ``root``.
    The first UNIQUE_ES ES words of each training item are made unique,
    so the word vocabulary reaches ~4,900 rows and TUNE_PARTIAL 1000 pins
    most of them."""
    import msgpack

    from ruart_tpu_torch.core.presets import STVQA_CONF
    from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset

    for label, n, seed in (("train", N_TRAIN, 0), ("val", N_VAL, 1),
                           ("test", N_TEST, 2)):
        raw = make_synthetic_raw_dataset(
            n, seed=seed, n_ocr_range=(15, 30), n_es=40,
            with_answers=label != "test",
        )
        if label == "train":
            for i, d in enumerate(raw["data"]):
                for j, e in enumerate(d["ES_ocr"][:UNIQUE_ES]):
                    e["word"] = _letters(i * UNIQUE_ES + j)
        with open(os.path.join(root, f"{label}.msgpack"), "wb") as f:
            msgpack.pack(raw, f)
    conf = os.path.join(root, "conf_train")
    lines = [
        "Task\ttrain,val,test", "train_FILE\ttrain.msgpack",
        "val_FILE\tval.msgpack", "test_FILE\ttest.msgpack",
        "preprocess_ocr_name\tocr_PMTD_ASTER,ES_ocr",
        "preprocess_od_name\tOD_bottom-up", "batch_size\t16", "epoch\t1",
        f"FEATURE_FOLDER\t{root}/features",
    ]
    with open(conf, "w") as f:
        f.write("\n".join(lines) + "\n" + STVQA_CONF)
    return conf


def profile_device(fn, label: str):
    """Run ``fn`` once under torch.profiler: device-busy share of the wall
    time and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
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
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")) == "DeviceType.CPU"),
                  reverse=True)[:8]
    busy = sum(us for us, _, _ in kernels)
    log(f"profile {label}: device busy {busy / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms wall ({100 * busy / wall_us:.1f}%, profiler on), "
        f"{sum(n for _, n, _ in kernels)} kernels and copies")
    for us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{count:<5d} "
            f"{key[:90]}")
    log("  host ops by self CPU time (profiler on):")
    for us, count, key in host:
        log(f"  {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def run_training(att, conf: str):
    """Phase 6, train half: the CLI's entry point on ``conf``. Every train
    step is wrapped to record its K1 launches and its (device) loss, and
    the cost of its CUDA graphs (``train_graph_cost``) is read when the
    trainer releases them at the end of training (``recorded.cost``)."""
    import ruart_tpu_torch.train.trainer as trainer_mod
    from ruart_tpu_torch.cli import main as cli_main

    steps = []
    factory = trainer_mod.make_train_step

    def recording_factory(*args, **kwargs):
        step = factory(*args, **kwargs)

        def recorded(state, q, ocr, od, gt):
            k1 = att.attention_rows_cuda
            before = k1.launches, k1.bf16_launches
            state, loss = step(state, q, ocr, od, gt)
            steps.append((k1.launches - before[0],
                          k1.bf16_launches - before[1], loss))
            return state, loss

        cost = {}

        def release():  # refers to no wrapper: no cycle keeps the trainer
            if step.graphs is not None and not cost:
                cost.update(train_graph_cost(step))
            step.release()

        recorded.step, recorded.release, recorded.cost = step, release, cost
        return recorded

    trainer_mod.make_train_step = recording_factory
    try:
        trainer = cli_main.main(["--conf_file", conf])
    finally:
        trainer_mod.make_train_step = factory
    return trainer, steps


def train_batches_on_device(trainer, n: int = 1):
    """The first ``n`` collated training batches of the trainer's data (in
    item order), on the card."""
    from ruart_tpu_torch.data.pipeline import device_put_batch, host_batch

    data = trainer._dataset(trainer._load_split("train"), "train")
    size = trainer.cfg.batch_size
    out = []
    for first in range(0, n * size, size):
        batch = trainer.collator([data[i] for i in range(first, first + size)])
        host = host_batch(batch, trainer.spec, trainer._h2d_slim,
                          pin=trainer.device.type == "cuda")
        out.append(device_put_batch(host, trainer.device)[:4])
    return out


def eval_graph_after_training(trainer):
    """The trainer's eval step after its steps: the CUDA graph of the first
    val batch's signature, captured at the evaluation before the first
    step, replays the weights the optimizer updated in place: scores equal
    to the eager step's (within 1e-6), and no new capture."""
    import torch

    from ruart_tpu_torch.train.train_step import make_eval_step

    val = trainer._dataset(trainer._load_split("val"), "dev")
    batch = trainer.collator([val[i] for i in range(trainer.cfg.batch_size)])
    q, ocr, od, gt, _ = trainer._device_put(trainer._host_put(batch))
    before = len(trainer.eval_step)
    got = trainer.eval_step(q, ocr, od, gt)[0].clone()
    want = make_eval_step(trainer.model, trainer.loss_fn,
                          graphs=False)(q, ocr, od, gt)[0]
    diff = (got - want).abs().max().item()
    log(f"phase 6: the eval step's graph captured before the steps ({before} "
        f"graphs, {len(trainer.eval_step) - before} new) against the eager "
        f"step on the trained weights: max |score diff| {diff:.3e}, "
        f"byte-equal {torch.equal(got, want)} (tol {GRAPH_TOL:g})")
    if not (diff <= GRAPH_TOL and len(trainer.eval_step) == before):
        raise AssertionError("phase 6: the eval graph did not replay the "
                             "trained weights")


def time_train_steps(trainer, batch, n: int = 10):
    """Median ms of ``n`` train steps on one batch, each ended by a
    synchronize (after 3 warm steps)."""
    import torch

    times = []
    for i in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, _ = trainer.train_step(trainer.state, *batch)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def compare_plain_step(att, trainer, batch):
    """Phase 7: one train step with the kernel and one with
    attention_impl='plain' from the same weights and batch, dropout off."""
    import dataclasses

    import torch

    from ruart_tpu_torch.core.config import Config
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import init_train_state, make_train_step

    opt = dict(trainer.opt)
    for key in ("DROPOUT", "dropout_emb"):
        opt.pop(key, None)
    cfg = Config(opt)
    weights = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    out = {}
    for arm, impl in (("kernel", "auto"), ("plain", "plain"), ("plain again", "plain")):
        spec = ModelSpec.from_config(
            cfg, dataclasses.replace(trainer.spec.bert, attention_impl=impl))
        with trainer.device:
            model = RUArtModel(spec)
        model.load_state_dict(weights)
        tx = Optimizer("#", LR, 10.0, model, spec, True)
        # eager: the arms' gradients are read from the step
        step = make_train_step(make_loss_fn("BCE_D1"),
                               make_row_pinner(model, spec, int(opt["tune_partial"])),
                               graphs=False)
        state = init_train_state(model, tx, 0)
        before = att.attention_rows_cuda.launches
        state, loss = step(state, *batch)
        launched = att.attention_rows_cuda.launches - before
        grads = {n: (p.grad.detach().clone() if p.grad is not None else None)
                 for n, p in model.named_parameters()}
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        out[arm] = (loss.item(), params, grads, launched)
        del model, state, tx
    (loss_k, p_k, g_k, n_k), (loss_p, p_p, g_p, n_p) = out["kernel"], out["plain"]
    g_again = out["plain again"][2]
    if n_k < trainer.spec.bert.num_hidden_layers or n_p != 0:
        raise AssertionError(f"phase 7: kernel launches {n_k} (kernel arm), "
                             f"{n_p} (plain arm)")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    names = [n for n in p_k if g_k[n] is not None]
    for n in p_k:
        if (g_k[n] is None) != (g_p[n] is None):
            raise AssertionError(f"phase 7: {n} has a gradient in one arm only")
    # gradients against the size of the whole gradient (a tensor whose own
    # gradient is ~0, like a bias in front of a softmax, holds only noise);
    # reported beside the plain arm's difference from itself, the floor
    # that cuDNN's backward leaves
    g_norm = torch.linalg.vector_norm(torch.stack([g_p[n].norm() for n in names]))

    def grad_diff(other):
        diffs = {n: ((other[n] - g_p[n]).norm() / g_norm).item() for n in names}
        name = max(diffs, key=diffs.get)
        return diffs[name], name

    worst_grad, grad_name = grad_diff(g_k)
    floor_grad, _ = grad_diff(g_again)
    worst, worst_name = 0.0, ""
    for name in names:
        gk, gp, pk = g_k[name], g_p[name], p_k[name]
        # an element whose gradient the two arms do not pin down to 1% (or
        # that is ~0) moves by +-lr in a direction rounding decides
        settled = (gp.abs() > 100 * (gk - gp).abs()) & (gp.abs() > 1e-7)
        diff = (pk - p_p[name]).abs()
        if settled.any() and diff[settled].max().item() > worst:
            worst, worst_name = diff[settled].max().item(), name
    for name, pk in p_k.items():
        for arm in (pk, p_p[name]):
            if (arm - weights[name]).abs().max().item() > LR * (1 + 1e-4):
                raise AssertionError(f"phase 7: {name} moved more than lr")
    log(f"phase 7: loss kernel {loss_k:.7f} plain {loss_p:.7f} (rel diff "
        f"{rel:.2e}, tol 1e-5); worst |grad kernel - grad plain| over the "
        f"global gradient norm {worst_grad:.2e} ({grad_name}; plain against "
        f"itself {floor_grad:.2e}); max |param kernel - param plain| where "
        f"the gradient is settled {worst:.3e} ({worst_name}, tol {0.05 * LR:g}); "
        f"every element within lr of its start; margins (value / limit): "
        f"loss {rel / 1e-5:.3f}, parameters {worst / (0.05 * LR):.3f}")
    if not (rel <= 1e-5 and worst <= 0.05 * LR):
        raise AssertionError("phase 7: the kernel's train step and the plain "
                             "version's disagree")
    return rel, worst


def bf16_serving(params, reqs, drive):
    """Phase 9 (a), (b): BF16 serving against its plain path and fp32."""
    n_batches = -(-N_REQUESTS // 16)
    engine, _ = build_engine("auto", params, BF16=True)
    plain, _ = build_engine("plain", params, BF16=True)
    fp32, _ = build_engine("auto", params)
    for e in (engine, plain, fp32):
        e.predict(reqs)  # captures the graphs: the driven passes replay
    got = drive("(a) BF16 predict, kernel", lambda: engine.predict(reqs),
                n_batches, bf16=True, exact=True)
    want = drive("(a) BF16 predict, plain", lambda: plain.predict(reqs), 0,
                 exact=True)
    ref = drive("(a) fp32 predict", lambda: fp32.predict(reqs), n_batches,
                exact=True)
    batches = [b[:3] for _, _, b in engine._collated_batches(reqs)]
    s_kernel, s_plain, s_fp32 = (batch_scores(e, reqs, batches)
                                 for e in (engine, plain, fp32))
    d_kp, d_pf, d_kf = (max_diff(s_kernel, s_plain), max_diff(s_plain, s_fp32),
                        max_diff(s_kernel, s_fp32))
    agree = sum(a["answer"] == b["answer"] for a, b in zip(got, want))
    agree32 = sum(a["answer"] == b["answer"] for a, b in zip(got, ref))
    log(f"phase 9 (a): max |score| kernel bf16 - plain bf16 {d_kp:.3e}, "
        f"plain bf16 - fp32 {d_pf:.3e}, kernel bf16 - fp32 {d_kf:.3e}; "
        f"answers kernel bf16 = plain bf16 on {agree}/{N_REQUESTS}, "
        f"kernel bf16 = fp32 on {agree32}/{N_REQUESTS}; margins (value / "
        f"limit): scores {d_kp / d_pf:.3f}, answers apart "
        f"{(N_REQUESTS - agree) / 2:.2f}")
    if not (all(math.isfinite(r["score"]) for r in got) and d_kp <= d_pf
            and agree >= N_REQUESTS - 2):
        raise AssertionError("phase 9: the bf16 kernel path is further from "
                             "its plain path than bf16 is from fp32, or the "
                             "answers disagree")
    log("phase 9 (a): BF16 against fp32")
    in_turns("fp32", lambda: fp32.predict(reqs), "bf16",
             lambda: engine.predict(reqs))
    log("phase 9 (a): where the BF16 serving pass spends its time")
    where_the_time_goes(engine, reqs)
    del plain, fp32
    int8 = engine.quantize()
    int8.predict(reqs)  # captures the int8 model's graphs
    out = drive("(b) BF16 + INT8_BERT predict", lambda: int8.predict(reqs),
                n_batches, bf16=True, exact=True)
    scores = batch_scores(int8, reqs, batches)
    ok = all(bool(s.isfinite().all()) for s in scores) and all(
        isinstance(r["answer"], str) and math.isfinite(r["score"]) for r in out)
    agree = sum(a["answer"] == b["answer"] for a, b in zip(out, got))
    log(f"phase 9 (b): BF16 + INT8_BERT: {len(out)} answers, scores finite "
        f"{ok}, answers = BF16 on {agree}/{N_REQUESTS}")
    if not ok:
        raise AssertionError("phase 9: BF16 + INT8_BERT scores are not finite")


def bf16_training(att, root, conf, drive):
    """Phase 9 (c): 10 BF16 steps of the train conf through ``cli.main`` in
    phase 6's folder, then one step with LOCK_BERT off."""
    import torch

    from ruart_tpu_torch.core.config import Config
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import init_train_state, make_train_step

    conf_bf16 = os.path.join(root, "conf_train_bf16")
    with open(conf) as f, open(conf_bf16, "w") as g:
        g.write("BF16\nepoch\t0.5\n" + f.read())
    t0 = time.time()
    # the evaluations at the start and the end launch K1 too: at least 12
    # per step
    trainer, steps = drive("(c) BF16 train through cli.main",
                           lambda: run_training(att, conf_bf16),
                           lambda out: len(out[1]), bf16=True)
    losses = [float(loss) for _, _, loss in steps]
    per_step = sorted({(n, b) for n, b, _ in steps})
    log(f"phase 9 (c): {len(steps)} BF16 steps in {time.time() - t0:.1f} s "
        f"(evaluations included), K1 (all, bf16) launches per step "
        f"{per_step}, losses {[round(x, 5) for x in losses]}")
    layers = trainer.spec.bert.num_hidden_layers
    if not (len(steps) == 10 and all(math.isfinite(x) for x in losses)
            and all(b == n == layers for n, b, _ in steps)):
        raise AssertionError("phase 9: BF16 training ran a step without K1 in "
                             "bf16, or a loss is not finite")
    [batch] = train_batches_on_device(trainer)
    opt = dict(trainer.opt)
    opt.pop("LOCK_BERT")
    spec = ModelSpec.from_config(Config(opt), trainer.spec.bert)
    with trainer.device:
        model = RUArtModel(spec)
    model.load_state_dict(trainer.model.state_dict())
    tx = Optimizer("#", LR, 10.0, model, spec, True)
    step = make_train_step(make_loss_fn("BCE_D1"),
                           make_row_pinner(model, spec, int(opt["tune_partial"])),
                           graphs=False)  # its gradients are read below
    state = init_train_state(model, tx, 0)
    _, loss = drive("(c) BF16 train step, LOCK_BERT off",
                    lambda: step(state, *batch), 1, bf16=True, exact=True)
    grads = [p.grad for n, p in model.named_parameters()
             if n.startswith("Bert.layer_")]
    finite = all(g is not None and bool(g.isfinite().all()) for g in grads)
    nonzero = finite and any(g.abs().max().item() > 0 for g in grads)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])).item()
    log(f"phase 9 (c): LOCK_BERT off: loss {float(loss):.6f}, {len(grads)} "
        f"encoder gradients finite {finite}, not all zero {nonzero}, global "
        f"norm {norm:.4e}, dtype {grads[0].dtype}")
    if not (math.isfinite(float(loss)) and finite and nonzero):
        raise AssertionError("phase 9: the unlocked BF16 step's encoder "
                             "gradients are not finite or all zero")
    del trainer, model, state, tx, batch


def branch_forwards(reqs, root, drive):
    """Phase 9 (d): one full-width forward of img_feature replace_od,
    fixed_answers and ES post_process, kernel against plain path."""
    import numpy as np

    n_batches = -(-N_REQUESTS // 16)
    path = os.path.join(root, "fixed_answers_4000.txt")
    with open(path, "w") as f:
        f.write("\n".join(f"fixed answer {i}" for i in range(N_FIXED)) + "\n")
    with open(path) as f:  # as the trainer reads it
        fixed = [line.strip().lower() for line in f if line.strip()]
    rng = np.random.RandomState(9)
    cases = (
        ("img_feature replace_od", dict(img_feature=True,
                                        img_fea_way="replace_od"), None),
        ("fixed_answers", dict(fixed_answers=True,
                               fixed_answers_len=len(fixed)), fixed),
        ("ES_using_way post_process", dict(ES_using_way="post_process"), None),
    )
    for label, opts, answers in cases:
        engine, params = build_engine("auto", None, **opts)
        plain, _ = build_engine("plain", params, **opts)
        engine.fixed_answers = plain.fixed_answers = answers
        batches = [b[:3] for _, _, b in engine._collated_batches(reqs)]
        if opts.get("img_feature"):
            for q, _, _ in batches:  # what the trainer's provider would give
                B = q["glove"].shape[0]
                q["img_features"] = rng.rand(B, *IMG).astype(np.float32)
                q["img_spatials"] = rng.rand(B, IMG[0], 8).astype(np.float32)
        got = drive(f"(d) {label} forward",
                    lambda: batch_scores(engine, reqs, batches), n_batches,
                    exact=True)
        diff = max_diff(got, batch_scores(plain, reqs, batches))
        rows = all(bool(s.isfinite().all())
                   and (s.sum(-1) - 1).abs().max().item() < 1e-4 for s in got)
        answers_out = None
        if not opts.get("img_feature"):
            engine.predict(reqs)  # captures the graphs
            answers_out = drive(f"(d) {label} predict",
                                lambda: engine.predict(reqs), n_batches,
                                exact=True)
        log(f"phase 9 (d): {label}: scores {tuple(got[0].shape)} per batch, "
            f"kernel vs plain max |diff| {diff:.3e} (tol {SCORE_TOL:g}), "
            f"finite softmax rows {rows}"
            + (f", predict answers e.g. {answers_out[0]['answer']!r}"
               if answers_out else ""))
        if not (diff <= SCORE_TOL and rows):
            raise AssertionError(f"phase 9: {label} kernel and plain paths "
                                 "disagree")
        del engine, plain


# -- phase 10: the (dp, tp) mesh ---------------------------------------------

MESH_GRIDS = ((2, 1), (1, 2), (2, 2), (1, 4))


def check_sharded_attention(att):
    """Phase 10 (a): the sharded call (the whole (dp, tp) grid in one
    process, every shard through the kernel on its local heads) against K1
    over all heads and against the plain version, at the serving shape in
    both bias forms, fp32 and bf16; a head count tp does not divide is
    refused. Returns the worst fp32 error."""
    import torch

    B, L, H, dh, _ = SERVE_SHAPE
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name in worst:
        dtype = getattr(torch, dtype_name)
        for bias_2d in (True, False):
            q, k, v, bias = make_inputs(B, L, H, dh, dtype, bias_2d, 31)
            full = att.attention_rows_cuda(q, k, v, bias, H)
            plain = att.attention_rows_plain(q, k, v, bias, H)
            for dp, tp in MESH_GRIDS:
                got = att.sharded_fused_attention_global(q, k, v, bias, H,
                                                         dp, tp)
                for ref in (full, plain):
                    err = (got.float() - ref.float()).abs().max().item()
                    worst[dtype_name] = max(worst[dtype_name], err)
    try:
        att.sharded_fused_attention_global(q, k, v, bias, H, 1, 5)
    except AssertionError as e:
        refused = str(e)
    else:
        raise AssertionError("phase 10: tp 5 over 12 heads was not refused")
    log(f"phase 10 (a): sharded call at (dp, tp) in {list(MESH_GRIDS)}, "
        f"{B} rows x L {L}, {H} heads of {dh}, both bias forms: worst error "
        f"against K1 over all heads and the plain version fp32 "
        f"{worst['float32']:.3e} (tol {TOL['float32']:g}), bf16 "
        f"{worst['bfloat16']:.3e} (tol {TOL['bfloat16']:g}); tp 5 refused "
        f"({refused})")
    if not all(worst[k] <= TOL[k] for k in worst):
        raise AssertionError("phase 10: the sharded call disagrees")
    return worst["float32"]


def nccl_world_of_one():
    """Phase 10 (b): NCCL through maybe_initialize_distributed at world
    size 1 (a localhost coordinator_address), one all_reduce on the card."""
    import torch
    import torch.distributed as dist

    from ruart_tpu_torch.parallel.distributed import (
        free_port,
        maybe_initialize_distributed,
    )

    t0 = time.time()
    opt = {"coordinator_address": f"localhost:{free_port()}",
           "num_processes": 1, "process_id": 0, "local_device_ids": "0"}
    if not maybe_initialize_distributed(opt, "cuda"):
        raise AssertionError("phase 10: no process group")
    backend = dist.get_backend()
    x = torch.arange(4.0, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    log(f"phase 10 (b): {backend} at world size 1: all_reduce gave "
        f"{x.tolist()} in {time.time() - t0:.2f} s (init included)")
    if backend != "nccl" or x.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError("phase 10: NCCL at world size 1 failed")


def mesh_conf(work):
    """The serving engine's conf (the shipped ST-VQA conf at batch 16) as
    the ranks and the single-process trainer read it."""
    from ruart_tpu_torch.core.presets import stvqa_config

    opt = dict(stvqa_config(
        vocab_size=5000, batch_size=16,
        preprocess_ocr_name="ocr_PMTD_ASTER,ES_ocr",
        preprocess_od_name="OD_bottom-up").opt)
    opt.update(datadir=work, FEATURE_FOLDER=work)
    return opt


def load_mesh_batches(work):
    """The collated host batches phase 10 (c) runs (numpy), and the train
    step's targets."""
    import numpy as np

    with np.load(os.path.join(work, "batches.npz")) as z:
        n = int(z["n"])
        batches = []
        for i in range(n):
            blocks = {}
            for name in ("q", "ocr", "od"):
                pre = f"{i}/{name}/"
                blocks[name] = {k[len(pre):]: z[k] for k in z.files
                                if k.startswith(pre)}
            batches.append((blocks["q"], blocks["ocr"], blocks["od"]))
        return batches, z["gt"]


@contextlib.contextmanager
def eager_trainer_steps():
    """Trainers set up inside the block take an eager train step
    (``graphs=False``), whose gradients can be read after the step: on the
    graph path ``param.grad`` belongs to the captured graph."""
    import functools

    import ruart_tpu_torch.train.trainer as trainer_mod

    factory = trainer_mod.make_train_step
    trainer_mod.make_train_step = functools.partial(factory, graphs=False)
    try:
        yield
    finally:
        trainer_mod.make_train_step = factory


def mesh_trainer(opt, device, tp=None):
    """A trainer with the engine's weights (``weights.ckpt``), set up
    without preprocessing."""
    from ruart_tpu_torch.core.config import Config
    from ruart_tpu_torch.train.trainer import Trainer

    if tp is not None:
        opt = dict(opt, tensor_parallel=tp)
    trainer = Trainer(Config(dict(opt)), device=device)
    trainer.setup_model({})
    trainer.load_model(os.path.join(opt["datadir"], "weights.ckpt"))
    return trainer


def on_device(trainer, batch, gt=None):
    """A host batch (and numpy targets) as the trainer puts it on its
    device (a rank's slice on the mesh)."""
    q, ocr, od = batch
    host = trainer._host_put((q, ocr, od, gt, None))
    return trainer._device_put(host)[:4]


def phase10_rank(rank, world, address, work, device="cuda"):
    """One of two ranks on the one card (gloo; NCCL refuses two ranks of a
    communicator on one device): the collectives the port uses on CUDA
    tensors; then through the conf keys and the trainer at dp 2 and at
    tp 2: the forward of every batch (K1 launches and local heads
    counted), one train step of the shipped train conf, and at tp 2 a
    full checkpoint and the scores after the step."""
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.parallel.distributed import (
        fetch_local_first,
        maybe_initialize_distributed,
    )
    from ruart_tpu_torch.parallel.layers import tp_dim
    from ruart_tpu_torch.train import checkpoint as ckpt

    opt = dict(mesh_conf(work), coordinator_address=address,
               num_processes=world, process_id=rank, local_device_ids="0")
    maybe_initialize_distributed(opt, device, backend="gloo")
    probe = {}
    for name, fn in (
        ("all_reduce", lambda x: dist.all_reduce(x)),
        ("all_gather", lambda x: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x)),
        ("broadcast", lambda x: dist.broadcast(x, src=0)),
    ):
        try:
            fn(torch.ones(8, device=device))
            probe[name] = "ok"
        except Exception as e:  # reported, and fails the phase
            probe[name] = f"{type(e).__name__}: {e}"
    batches, gt = load_mesh_batches(work)
    written = []
    write = ckpt._write

    def record_write(path, arrays, meta):
        written.append(os.path.basename(path))
        write(path, arrays, meta)

    ckpt._write = record_write
    heads = collections.Counter()
    rows = att.attention_rows

    def record_heads(q, k, v, bias, n_heads):
        heads[n_heads] += 1
        return rows(q, k, v, bias, n_heads)

    att.attention_rows = record_heads
    out = {"probe": probe}
    arrays = {}
    for label, tp in (("dp2", 1), ("tp2", 2)):
        trainer = mesh_trainer(opt, device, tp)
        heads.clear()
        att.attention_rows_cuda.launches = 0
        att.sharded_fused_attention.launches = 0
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        sync()
        t0 = time.time()
        for i, batch in enumerate(batches):
            scores, _ = trainer.eval_step(*on_device(trainer, batch))
            arrays[f"{label}/scores/{i}"] = scores.cpu().numpy()
        dev = on_device(trainer, batches[0], gt)
        trainer.state, loss = trainer.train_step(trainer.state, *dev)
        sync()
        wall = time.time() - t0
        stats = {"mesh": trainer.mesh.shape, "wall_s": wall,
                 "k1": att.attention_rows_cuda.launches,
                 "sharded": att.sharded_fused_attention.launches,
                 "heads": dict(heads), "loss": float(loss)}
        # the step's gradient of the global batch (summed over the copies
        # as the optimizer sums it) and the updated parameters, tp shards
        # gathered: every rank takes part, rank 0 keeps them
        grads = trainer.optimizer._reduce_grads([
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in trainer.optimizer.params.values()])
        for (name, p), g in zip(trainer.optimizer.params.items(), grads):
            g = fetch_local_first(g, trainer.mesh, tp_dim(p),
                                  materialize=rank == 0)
            if rank == 0:
                arrays[f"{label}/grad/{name}"] = g
        model = trainer._host_model()
        if rank == 0:
            state = model.state_dict()
            for name in trainer.optimizer.params:
                arrays[f"{label}/param/{name}"] = state[name].cpu().numpy()
        if tp == 2:
            trainer.save(os.path.join(work, "tp2_full.ckpt"))
            scores, _ = trainer.eval_step(*on_device(trainer, batches[0]))
            arrays["tp2/after"] = scores.cpu().numpy()
        out[label] = stats
        del trainer, model
    att.attention_rows = rows
    out["written"] = written
    with open(os.path.join(work, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        np.savez(os.path.join(work, "rank_0.npz"), **arrays)
    dist.destroy_process_group()


def mesh_ranks(att, work, engine, params, kernel_scores, device="cuda"):
    """Phase 10 (c): two ranks on the one card through the conf keys and
    the trainer, against the single-process kernel path: forward scores
    within 1e-4 of phase 3's, the train step's loss within 1e-5 relative
    and its updated parameters within 0.05 * lr (where the gradients are
    settled, as in phase 7), K1 on every rank (12
    heads at dp 2, 6 at tp 2), rank 0 the only writer, and the tp-2
    checkpoint giving the same scores in a single-process trainer.
    Returns the sharded call's launches over the ranks."""
    import numpy as np
    import torch

    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.parallel.launch import spawn
    from ruart_tpu_torch.train import checkpoint as ckpt

    batches = [b[:3] for _, _, b in engine._collated_batches(requests())]
    rng = np.random.RandomState(10)
    C = kernel_scores[0].shape[1]
    gt = np.zeros((16, C), np.float32)
    gt[np.arange(16), rng.randint(0, C, 16)] = 1.0
    np.savez(os.path.join(work, "batches.npz"), n=len(batches), gt=gt, **{
        f"{i}/{name}/{k}": v for i, b in enumerate(batches)
        for name, block in zip(("q", "ocr", "od"), b) for k, v in block.items()})
    full = RUArtModel(engine.spec)
    full.load_state_dict(params)
    ckpt.save_checkpoint(os.path.join(work, "weights.ckpt"), full)
    del full

    # the single-process kernel path's train step, from the same weights
    opt = mesh_conf(work)
    with eager_trainer_steps():
        single = mesh_trainer(opt, device)
    dev = on_device(single, batches[0], gt)
    single.state, loss = single.train_step(single.state, *dev)
    want_loss = float(loss)
    want = {n: p.detach().cpu().numpy()
            for n, p in single.optimizer.params.items()}
    want_grad = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .cpu().numpy() for n, p in single.optimizer.params.items()}
    lr = single.optimizer.lr
    del single, dev

    t0 = time.time()
    spawn("chip_smoke:phase10_rank", 2, args=(work, device), timeout=300)
    wall = time.time() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    got = dict(np.load(os.path.join(work, "rank_0.npz")))
    log(f"phase 10 (c): 2 gloo ranks on the one card in {wall:.1f} s wall "
        f"(process start, model build and load included; correctness, not "
        f"speed); gloo on CUDA tensors: {ranks[0]['probe']}")
    failures = []
    for label, heads in (("dp2", 12), ("tp2", 6)):
        diff = max(float(np.abs(got[f"{label}/scores/{i}"]
                                - s.float().cpu().numpy()).max())
                   for i, s in enumerate(kernel_scores))
        rel = abs(ranks[0][label]["loss"] - want_loss) / abs(want_loss)
        # as phase 7: parameters are compared where the two gradients pin
        # each other down to 1% and exceed 1e-7; elsewhere Adamax moves an
        # element by up to lr in a direction rounding decides
        worst, settled_n, grad_worst = 0.0, 0, 0.0
        g_norm = math.sqrt(sum(float((g ** 2).sum()) for g in want_grad.values()))
        for name, w in want.items():
            p, g = got[f"{label}/param/{name}"], got[f"{label}/grad/{name}"]
            gw = want_grad[name]
            grad_worst = max(grad_worst,
                             float(np.linalg.norm(g - gw)) / g_norm)
            settled = (np.abs(gw) > 100 * np.abs(g - gw)) & (np.abs(gw) > 1e-7)
            if settled.any():
                worst = max(worst, float(np.abs(p - w)[settled].max()))
            settled_n += int(settled.sum())
        for r, rank in enumerate(ranks):
            st = rank[label]
            log(f"phase 10 (c): {label} rank {r}: mesh {st['mesh']}, K1 "
                f"launches {st['k1']} (sharded call {st['sharded']}), local "
                f"heads per launch {st['heads']}, {len(batches)} forwards + "
                f"1 train step in {st['wall_s']:.2f} s")
            if st["k1"] == 0 or set(map(int, st["heads"])) != {heads}:
                failures.append(f"{label} rank {r}: K1 {st['k1']} launches, "
                                f"heads {st['heads']}")
            if label == "tp2" and st["sharded"] == 0:
                failures.append(f"tp2 rank {r}: no sharded call")
        log(f"phase 10 (c): {label}: max |score - single-process kernel "
            f"path| {diff:.3e} (tol {SCORE_TOL:g}); loss {ranks[0][label]['loss']:.7f}"
            f" vs {want_loss:.7f} (rel {rel:.2e}, tol 1e-5); worst "
            f"|grad - grad single| over the global gradient norm "
            f"{grad_worst:.2e}; updated parameters max |diff| {worst:.3e} "
            f"over {settled_n} settled elements (tol {0.05 * lr:g}); margins "
            f"(value / limit): scores {diff / SCORE_TOL:.3f}, loss "
            f"{rel / 1e-5:.3f}, parameters {worst / (0.05 * lr):.3f}")
        if not (diff <= SCORE_TOL and rel <= 1e-5 and worst <= 0.05 * lr):
            failures.append(f"{label} disagrees with the single-process path")
    if any(v != "ok" for v in ranks[0]["probe"].values()):
        failures.append(f"gloo refused a CUDA collective: {ranks[0]['probe']}")
    if ranks[1]["written"] or "tp2_full.ckpt" not in ranks[0]["written"]:
        failures.append(f"checkpoint writes: {[r['written'] for r in ranks]}")
    loaded = mesh_trainer(dict(opt), device)
    loaded.load_model(os.path.join(work, "tp2_full.ckpt"))
    scores, _ = loaded.eval_step(*on_device(loaded, batches[0]))
    diff = float(np.abs(scores.cpu().numpy() - got["tp2/after"]).max())
    log(f"phase 10 (c): writes rank 0 {ranks[0]['written']}, rank 1 "
        f"{ranks[1]['written']}; the tp-2 checkpoint in a single-process "
        f"trainer: max |score diff| {diff:.3e} against the ranks' scores "
        f"after their step (tol {SCORE_TOL:g})")
    if not diff <= SCORE_TOL:
        failures.append("the tp-2 checkpoint gives other scores")
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures))
    return sum(r[label]["sharded"] for r in ranks for label in ("dp2", "tp2"))


# -- phase 11: PHOC, native host code, chunked BERT, attention maps ---------

PHOC_OCR_EMBEDDING = "phoc,fasttext,pos,ent,bert"
N_PHOC_WORDS = 5000          # the serve configuration's vocabulary rows
CHUNKED = (4, 1024)          # rows x L through encode_chunked: 2 chunks
CHUNK_SHAPE = (4, 512, 12, 64, False)  # K1 on one chunk: key bias


def same_bytes(a, b) -> bool:
    """Nested dicts / tuples / lists of numpy arrays equal byte for byte
    (dtype and shape included)."""
    import numpy as np

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_bytes(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bytes(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def phoc_words(vocab):
    """The phase's 5,000 words: the engine's vocabulary, then seeded words
    with digits, case and punctuation that the encoder filters out."""
    words = list(vocab)[:N_PHOC_WORDS]
    for i in range(N_PHOC_WORDS - len(words)):
        w = _letters(i) + str(i % 97)
        words.append(w.upper() + "-!" if i % 3 == 0 else w)
    return words


def native_host(engine, reqs, device="cuda"):
    """Phase 11 (a): build both native libraries with g++ (timed), the
    native PHOC encoder against its Python oracle and the tensor op on
    ``device`` over the 5,000 words (byte for byte), the serving batches
    collated natively against the numpy path (byte for byte), and host
    featurize + collate ms per pass with each, in turns. Returns the
    words."""
    import numpy as np
    import torch

    from ruart_tpu_torch.data import collate
    from ruart_tpu_torch.native import build
    from ruart_tpu_torch.ops.phoc import encode_char_ids, phoc_from_char_ids
    from ruart_tpu_torch.text import phoc

    t0 = time.perf_counter()
    build.ensure_built(force=True)
    phoc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    build.load_fastcollate(force=True)
    fc_s = time.perf_counter() - t0
    collate._fc.cache_clear()  # the collator loads the fresh build
    active = collate.native_active()
    log(f"phase 11 (a): g++ built {build.PHOC_LIBRARY.name} in {phoc_s:.2f} s "
        f"and {build.FASTCOLLATE_LIBRARY.name} in {fc_s:.2f} s; native "
        f"collate active: {active}")
    if not active:
        raise AssertionError("phase 11: the native collator is not active")

    words = phoc_words(engine._pre.train_vocab)
    t0 = time.perf_counter()
    native = phoc.build_phoc_batch(words)
    native_ms = (time.perf_counter() - t0) * 1e3
    oracle = np.stack([phoc.build_phoc_py(w) for w in words])
    max_len = max(len(phoc.filter_token(w)) for w in words)
    ids, lengths = encode_char_ids(words, max_len)
    on_device = phoc_from_char_ids(torch.from_numpy(ids).to(device),
                                   torch.from_numpy(lengths).to(device))
    got = on_device.cpu().numpy()
    ok = (native.shape == (N_PHOC_WORDS, 604)
          and native.tobytes() == oracle.tobytes()
          and got.tobytes() == native.tobytes())
    log(f"phase 11 (a): PHOC of {len(words)} words ({int(native.sum())} set "
        f"bits): native {native_ms:.1f} ms, byte-equal to the Python oracle "
        f"{native.tobytes() == oracle.tobytes()}; phoc_from_char_ids on "
        f"{on_device.device} (max_len {max_len}) byte-equal to the native "
        f"batch {got.tobytes() == native.tobytes()}")
    if not ok:
        raise AssertionError("phase 11: the PHOC encoders disagree")

    fast = collate._fc

    def numpy_path(fn):
        collate._fc = lambda: None
        try:
            return fn()
        finally:
            collate._fc = fast

    def batches():
        return [b for _, _, b in engine._collated_batches(reqs)]

    native_b, numpy_b = batches(), numpy_path(batches)
    equal = same_bytes(native_b, numpy_b)
    times = {"native": [], "numpy": []}
    for i in range(6):
        arm = ("native", "numpy")[(i + i // 2) % 2]  # n, u, u, n, n, u
        t0 = time.perf_counter()
        if arm == "native":
            batches()
        else:
            numpy_path(batches)
        times[arm].append((time.perf_counter() - t0) * 1e3)
    log(f"phase 11 (a): {len(native_b)} serving batches collated natively "
        f"byte-equal to the numpy path: {equal}; host featurize + collate per "
        f"pass of {N_REQUESTS} requests, in turns: native "
        f"{[round(x, 1) for x in times['native']]} ms (median "
        f"{statistics.median(times['native']):.1f}), numpy "
        f"{[round(x, 1) for x in times['numpy']]} ms (median "
        f"{statistics.median(times['numpy']):.1f}) (smoke reading, not a cell)")
    if not equal:
        raise AssertionError("phase 11: native and numpy collate disagree")
    return words


def phoc_paths(words, reqs, root, conf, drive, device="cuda"):
    """Phase 11 (b): ``PHOC`` at the width of phase 2: the 40 requests
    through ``predict`` with the kernel and with the plain path (scores
    within 1e-4, K1 12 times per batch), then one train step of the
    shipped train conf with ``PHOC`` and ``fixed_answers`` (4,000 answers)
    through the trainer: the table written by its preprocessor, the fixed
    answers' PHOC vectors against the oracle, a finite loss."""
    import numpy as np
    import torch

    from ruart_tpu_torch.cli.main import build_config
    from ruart_tpu_torch.text import phoc
    from ruart_tpu_torch.train.trainer import Trainer

    n_batches = -(-N_REQUESTS // 16)
    opts = dict(PHOC=True, ocr_embedding=PHOC_OCR_EMBEDDING)
    engine, params = build_engine("auto", None, device=device, **opts)
    params["phoc_embed.weight"] = torch.from_numpy(
        phoc.build_phoc_embedding(words))
    with torch.no_grad():
        engine.model.phoc_embed.weight.copy_(params["phoc_embed.weight"])
    plain, _ = build_engine("plain", params, device=device, **opts)
    table = engine.model.phoc_embed.weight
    engine.predict(reqs)  # captures the graphs: the driven pass replays
    out = drive("(b) PHOC predict", lambda: engine.predict(reqs), n_batches,
                exact=True)
    got = batch_scores(engine, reqs)
    diff = max_diff(got, batch_scores(plain, reqs))
    rows = all(bool(s.isfinite().all())
               and (s.sum(-1) - 1).abs().max().item() < 1e-4 for s in got)
    log(f"phase 11 (b): PHOC serving: table {tuple(table.shape)}, {len(out)} "
        f"answers (e.g. {out[0]['answer']!r}), scores {tuple(got[0].shape)} per "
        f"batch, kernel vs plain max |diff| {diff:.3e} (tol {SCORE_TOL:g}), "
        f"finite softmax rows {rows}")
    if not (diff <= SCORE_TOL and rows and len(out) == N_REQUESTS):
        raise AssertionError("phase 11: the PHOC kernel and plain paths "
                             "disagree")
    del engine, plain, params

    # the shipped train conf with PHOC and fixed_answers, preprocessed anew
    # (the preprocessor writes the PHOC table into the meta)
    conf_phoc = os.path.join(root, "conf_train_phoc")
    with open(conf) as f, open(conf_phoc, "w") as g:
        g.write(f"PHOC\nocr_embedding\t{PHOC_OCR_EMBEDDING}\nfixed_answers\n"
                f"fixed_answers_folder\t{root}\n"
                f"FEATURE_FOLDER\t{root}/features_phoc\n" + f.read())
    t0 = time.time()
    trainer = Trainer(build_config(conf_phoc), device=device)
    vocab, _, embeddings = trainer._preprocess()
    trainer.vocab = vocab
    trainer.setup_model(embeddings)
    fixed = trainer.fixed_answers_entry["fixed_answers_phoc"]
    oracle = np.stack([phoc.build_phoc_py(a) for a in trainer.fixed_answers])
    [batch] = train_batches_on_device(trainer)
    q, ocr, od = batch[:3]
    # the dataset's labels are one column short of the fixed-answers head
    # in both packages (ROADMAP, Queue 3): seeded targets of the head's width
    with torch.no_grad():
        width = trainer.model.eval()(q, ocr, od).shape[1]
    rng = np.random.RandomState(11)
    gt = np.zeros((trainer.cfg.batch_size, width), np.float32)
    gt[np.arange(len(gt)), rng.randint(0, width, len(gt))] = 1.0
    gt = torch.from_numpy(gt).to(trainer.device)
    trainer.state, loss = drive(
        "(b) PHOC + fixed_answers train step",
        lambda: trainer.train_step(trainer.state, q, ocr, od, gt), 1,
        exact=True)
    loss = float(loss)
    phoc_rows = tuple(trainer.model.phoc_embed.weight.shape)
    log(f"phase 11 (b): PHOC + fixed_answers train step: preprocessed table "
        f"{tuple(embeddings['phoc_embedding'].shape)} (model {phoc_rows}), "
        f"fixed_answers_phoc {tuple(fixed.shape)} byte-equal to the oracle "
        f"{fixed.tobytes() == oracle.tobytes()}, scores width {width}, loss "
        f"{loss:.6f}, {time.time() - t0:.1f} s with preprocessing")
    if not (fixed.shape == (N_FIXED, 604) and fixed.tobytes() == oracle.tobytes()
            and math.isfinite(loss)
            and embeddings["phoc_embedding"].shape[1] == 604):
        raise AssertionError("phase 11: the PHOC train step failed")
    del trainer, batch


def bert_weights(params):
    """The BERT-base encoder's entries of the serving model's state."""
    return {k[len("Bert."):]: v for k, v in params.items()
            if k.startswith("Bert.")}


def chunked_bert(att, params, engine, reqs, drive, device="cuda"):
    """Phase 11 (c): BERT-base over 4 rows of L 1,024 with a key mask
    through ``encode_chunked`` (2 chunks of 512), kernel against plain
    (1e-4; every chunk keeps a valid key), K1 timed at the chunk's shape,
    and ``BertWordEncoder`` on one serving batch's question rows, kernel
    against plain (1e-4). Returns K1's timing at the chunk's shape."""
    import torch

    from ruart_tpu_torch.models.bert.config import BertConfig
    from ruart_tpu_torch.models.bert.model import (
        BertModel,
        BertWordEncoder,
        encode_chunked,
    )

    weights = bert_weights(params)
    models = {}
    for impl in ("auto", "plain"):
        with torch.device(device):
            models[impl] = BertModel(BertConfig(attention_impl=impl))
        models[impl].load_state_dict(weights)
        models[impl].eval()
    rows, L = CHUNKED
    g = torch.Generator().manual_seed(12)
    lens = torch.randint(L // 2 + 1, L + 1, (rows,), generator=g)
    mask = (torch.arange(L)[None] < lens[:, None]).long()
    ids = torch.randint(1000, 30000, (rows, L), generator=g) * mask
    ids, mask = ids.to(device), mask.to(device)
    with torch.inference_mode():
        got = drive("(c) encode_chunked", lambda: encode_chunked(
            models["auto"], ids, mask, 512), 2, exact=True)
        want = encode_chunked(models["plain"], ids, mask, 512)
    diff = (got - want).abs().max().item()
    log(f"phase 11 (c): encode_chunked over {rows} rows x L {L} (lengths "
        f"{lens.tolist()}): {tuple(got.shape)}, kernel vs plain max |diff| "
        f"{diff:.3e} (tol {SCORE_TOL:g})")
    if not (diff <= SCORE_TOL and bool(got.isfinite().all())):
        raise AssertionError("phase 11: encode_chunked kernel and plain "
                             "disagree")
    timing = time_kernel(att, CHUNK_SHAPE) if device == "cuda" else None
    if timing is not None:
        log_timing("K1 at the chunk's shape", CHUNK_SHAPE, timing)

    q = next(iter(engine._collated_batches(reqs)))[2][0]
    args = [torch.from_numpy(q[k]).long().to(device)
            for k in ("bert", "bert_mask", "bert_offsets")]
    args.append((torch.from_numpy(q["glove"]) != 0).long().to(device))
    encoders = {}
    for impl in ("auto", "plain"):
        with torch.device(device):
            enc = BertWordEncoder(BertConfig(attention_impl=impl))
        enc.load_state_dict({**{f"bert.{k}": v for k, v in weights.items()},
                             "alphaBERT": params["alphaBERT"],
                             "gammaBERT": params["gammaBERT"]})
        encoders[impl] = enc.eval()
    with torch.inference_mode():
        got = drive("(c) BertWordEncoder", lambda: encoders["auto"](*args), 1,
                    exact=True)
        want = encoders["plain"](*args)
    diff = (got - want).abs().max().item()
    log(f"phase 11 (c): BertWordEncoder on a serving batch's question rows "
        f"{tuple(args[0].shape)} -> {tuple(got.shape)}, kernel vs plain max "
        f"|diff| {diff:.3e} (tol {SCORE_TOL:g})")
    if not (diff <= SCORE_TOL and bool(got.isfinite().all())):
        raise AssertionError("phase 11: BertWordEncoder kernel and plain "
                             "disagree")
    return timing


WARMUP_SPINS = 20  # spin kernels a profiled region starts with


def device_kernels(fn) -> int:
    """Device kernels ``fn`` launches (torch.profiler; copies, memsets and
    the warm-up's spin kernels left out). A session can miss the first
    kernels it sees: in a process that had run many sessions, most counts
    of phase 11 (d)'s forward came out 8-10 short and some whole (722-724
    where a fresh process counts 732, on an H100). So the region starts
    with WARMUP_SPINS spin kernels and a synchronize before ``fn``. The
    device finishes inside the region: a kernel still running when the
    profiler stops may go unrecorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(WARMUP_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")) == "DeviceType.CUDA"
               and not e.key.startswith(("Memcpy", "Memset"))
               and "spin_kernel" not in e.key)


PROFILED_RUNS = 3


def kernel_count(fn):
    """(the most frequent of PROFILED_RUNS :func:`device_kernels` counts of
    ``fn``, the raw counts). The profiler now and then drops events of a
    run, so one count is not the forward's. Three different counts: the
    largest (a dropped event only lowers a count)."""
    raw = [device_kernels(fn) for _ in range(PROFILED_RUNS)]
    top = collections.Counter(raw).most_common()
    return max(c for c, n in top if n == top[0][1]), raw


def attention_maps(engine, reqs, root, drive, device="cuda"):
    """Phase 11 (d): ``forward_with_attention`` on one serving batch:
    scores equal to ``predict``'s forward (1e-6), every alpha finite with
    rows summing to 1; a forward with recording off launches as many
    kernels as one before recording and one during it. (e): one forward
    inside ``profiler_trace``: the trace it writes names K1's kernel."""
    import torch

    from ruart_tpu_torch.models.fusion.introspect import forward_with_attention
    from ruart_tpu_torch.utils.timing import profiler_trace

    batch = [b[:3] for _, _, b in engine._collated_batches(reqs)][:1]
    blocks = [engine.to_device(b) for b in batch[0]]
    want = batch_scores(engine, reqs, batch)[0]
    with torch.inference_mode():
        scores, alphas = drive(
            "(d) forward_with_attention",
            lambda: forward_with_attention(engine.model, *blocks), 1,
            exact=True)
    diff = (scores - want).abs().max().item()
    sums = max((a.sum(-1) - 1).abs().max().item() for a in alphas.values())
    finite = all(bool(a.isfinite().all()) for a in alphas.values())
    counts, raw, first = {}, {}, None
    if device == "cuda":
        with torch.inference_mode():
            run = lambda: engine.model(*blocks)  # noqa: E731
            # printed, not compared: without the synchronize in
            # device_kernels one run counted 736 kernels and copies here
            # against 744 in the two counts after it
            first = device_kernels(run)
            for arm, fn in (("off, before", run),
                            ("recording", lambda: forward_with_attention(
                                engine.model, *blocks)),
                            ("off, after", run)):
                counts[arm], raw[arm] = kernel_count(fn)
    log(f"phase 11 (d): {len(alphas)} attention maps "
        f"({', '.join(sorted(alphas)[:4])}, ...), scores vs predict's forward "
        f"max |diff| {diff:.3e} (tol 1e-6), alphas finite {finite}, worst "
        f"|row sum - 1| {sums:.3e}; device kernels per forward, the most "
        f"frequent of {PROFILED_RUNS} counts each, {counts} (raw counts "
        f"{raw}; first profiled forward {first})")
    if not (diff <= 1e-6 and finite and sums <= 1e-5 and len(alphas) >= 6
            and len(set(counts.values())) <= 1):
        raise AssertionError("phase 11: forward_with_attention disagrees")

    logdir = os.path.join(root, "trace")

    def traced():
        with torch.inference_mode(), profiler_trace(logdir):
            engine.model(*blocks)

    drive("(e) forward in profiler_trace", traced, 1, exact=True)
    traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, traces[0])) as f:
        named = "attention_kernel" in f.read()
    log(f"phase 11 (e): profiler_trace wrote {traces}; names K1's kernel "
        f"(attention_kernel): {named}")
    if not (len(traces) == 1 and (named or device != "cuda")):
        raise AssertionError("phase 11: the trace does not name K1's kernel")



# -- phase 12: the eval step as one CUDA graph per batch signature ----------

GRAPH_TOL = 1e-6  # graph replay against the eager step, fp32 scores
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")


def forward_scores(engine, batches):
    """The engine's scores for each (q, ocr, od) host batch, copied out of
    the graph's static outputs at once."""
    return [engine._forward([engine.to_device(b) for b in batch]).clone()
            for batch in batches]


def graphs_against_eager(params, reqs, drive, device="cuda"):
    """Phase 12 (a): fp32, BF16 and INT8_BERT, each on a graph engine and
    an eager one: after a pass that captures, the 40 requests through
    ``predict`` with the counts set to 0 (K1 exactly 12 per batch on both,
    in bf16 under BF16), answers and idx equal and scores within 1e-6, the
    forward of each batch byte-equal or within 1e-6. Returns the fp32
    graph engine's answers."""
    import torch

    n_batches = -(-N_REQUESTS // 16)
    answers = None
    for label, opts, quant in (("fp32", {}, False),
                               ("BF16", {"BF16": True}, False),
                               ("INT8_BERT", {}, True)):
        engines = {}
        for graphs in (True, False):
            engines[graphs] = build_engine("auto", params, device=device,
                                           graphs=graphs, **opts)[0]
            if quant:
                engines[graphs].quantize()
        g, e = engines[True], engines[False]
        g.predict(reqs)  # captures this pass's signatures
        captured = g.graph_count
        log(f"phase 12 (a): {label}: graph pool after {captured} captures "
            f"{pool_bytes(g.eval_step.pool)} bytes")
        bf16 = "BF16" in opts
        got = drive(f"(a) {label} predict, graphs", lambda: g.predict(reqs),
                    n_batches, bf16=bf16, exact=True)
        want = drive(f"(a) {label} predict, eager", lambda: e.predict(reqs),
                     n_batches, bf16=bf16, exact=True)
        compare_answers(f"(a) {label} graphs vs eager", got, want,
                        tol=GRAPH_TOL, phase="phase 12")
        batches = [b[:3] for _, _, b in e._collated_batches(reqs)]
        sg, se = forward_scores(g, batches), forward_scores(e, batches)
        equal = all(torch.equal(a, b) for a, b in zip(sg, se))
        diff = max_diff(sg, se)
        log(f"phase 12 (a): {label}: {captured} graphs for {n_batches} "
            f"batches; forward scores graphs vs eager byte-equal {equal}, "
            f"max |diff| {diff:.3e} (tol {GRAPH_TOL:g}); K1 12 per batch on "
            f"both paths")
        if not (diff <= GRAPH_TOL and captured >= 1
                and e.graph_count == 0):
            raise AssertionError(f"phase 12: {label} graph path disagrees "
                                 "with the eager path")
        if answers is None:
            answers = got
        del engines, g, e
    return answers


def pool_segments(pool):
    """The device segments (cudaMalloc'd ranges) of one graph memory pool
    (``torch.cuda.memory_snapshot`` entries)."""
    import torch

    return [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool)]


def pool_bytes(pool) -> int:
    """Bytes of the device segments of one graph memory pool."""
    return sum(s["total_size"] for s in pool_segments(pool))


def warm_graphs(params, reqs, drive, device="cuda"):
    """Phase 12 (b): ``warmup_calibrated`` on a fresh graph engine: as many
    graphs as signatures, then the 40 requests capture nothing new.
    Returns (capture seconds per signature, pool bytes)."""
    import torch

    n_batches = -(-N_REQUESTS // 16)
    g, _ = build_engine("auto", params, device=device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    n = drive("(b) warmup_calibrated, graphs",
              lambda: g.warmup_calibrated(reqs), lambda n: n)
    wall = time.perf_counter() - t0
    warmed = g.graph_count
    drive("(b) predict after warmup_calibrated", lambda: g.predict(reqs),
          n_batches, exact=True)
    seconds = sorted(x.seconds for x in g.eval_step.graphs.values())
    segments = pool_segments(g.eval_step.pool)
    pool = sum(x["total_size"] for x in segments)
    active = sum(b["size"] for x in segments for b in x.get("blocks", ())
                 if b.get("state") == "active_allocated")
    sizes = sorted((x["total_size"] for x in segments), reverse=True)
    added = torch.cuda.memory_reserved() - reserved
    live = g.graph_count
    del g
    e, _ = build_engine("auto", params, device=device, graphs=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    e.warmup_calibrated(reqs)
    eager_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base[0],
            torch.cuda.max_memory_reserved() - base[1])
    del e
    log(f"phase 12 (b): eager warmup_calibrated {eager_s:.3f} s, peak "
        f"{peak[0]} bytes allocated and {peak[1]} reserved above the "
        f"weights")
    log(f"phase 12 (b): graph pool {pool} bytes in {len(sizes)} segments "
        f"(largest {sizes[:4]} bytes), of which {active} in allocated "
        f"blocks: the rest is free, but a capture whose blocks fit no free "
        f"segment allocates another")
    log(f"phase 12 (b): warmup_calibrated {n} signatures in {wall:.3f} s, "
        f"{warmed} graphs; capture seconds per signature median "
        f"{statistics.median(seconds):.4f}, max {seconds[-1]:.4f}; the live "
        f"pass captured {live - warmed}; graph pool {pool} bytes "
        f"(device memory reserved by the warmup {added} bytes)")
    if not (n == warmed >= 1 and live == warmed):
        raise AssertionError("phase 12: warmup_calibrated left a signature "
                             "to capture live")
    return seconds, pool


def graph_server(params, reqs, want, drive, device="cuda"):
    """Phase 12 (c): ``BatchingServer`` on a fresh graph engine: every
    signature is met cold inside ``dispatch`` on the device thread while
    the gather thread prepares the next waves (the capture is
    thread-local). The burst's answers equal ``predict``'s (scores within
    1e-4, as phase 8 c), a lone request equals the eager engine's, and
    the engine holds one graph per signature the waves had."""
    from ruart_tpu_torch.serve import BatchingServer
    from ruart_tpu_torch.utils.graphs import signature

    n_batches = -(-N_REQUESTS // 16)
    g, _ = build_engine("auto", params, device=device)
    eager, _ = build_engine("auto", params, device=device, graphs=False)
    submit_ms = []

    def burst():
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in reqs]
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        return [f.result(timeout=300) for f in futs]

    with BatchingServer(g, max_wait_ms=10) as server:
        served = drive("(c) BatchingServer burst, graphs met cold", burst,
                       n_batches)
        lone = drive("(c) BatchingServer lone request, graphs",
                     lambda: server.predict_one(reqs[0], timeout=300), 1)
        stats = server.stats()
    sigs = {signature([g.to_device(b) for b in batch[:3]] + [None])
            for _, _, batch in list(g._collated_batches(reqs))
            + list(g._collated_batches(reqs[:1]))}
    compare_answers("(c) burst on graphs vs predict", served, want,
                    phase="phase 12")
    compare_answers("(c) lone request on graphs vs eager", [lone],
                    eager.predict(reqs[:1]), tol=GRAPH_TOL, phase="phase 12")
    log(f"phase 12 (c): {stats['batches']} waves, {g.graph_count} graphs "
        f"captured inside dispatch for {len(sigs)} signatures; stats "
        f"{json.dumps(stats)}")
    log_wave_margin("12 (c)", submit_ms, server)
    if not (stats["batches"] == n_batches + 1 and g.graph_count == len(sigs)):
        raise AssertionError("phase 12: the server's graphs do not match "
                             "its signatures")


def main_test_graphs(folder, conf_predict, drive):
    """Phase 12 (d): ``cli.main_test`` with the trainer's eval step on
    graphs and eager: equal submissions."""
    import functools

    import ruart_tpu_torch.train.trainer as trainer_mod
    from ruart_tpu_torch.cli import main_test as cli_main_test
    from ruart_tpu_torch.utils.graphs import SignatureGraphs

    factory = trainer_mod.make_eval_step
    subs, n_graphs = {}, {}
    for graphs in (True, False):
        if not graphs:
            trainer_mod.make_eval_step = functools.partial(factory,
                                                           graphs=False)
        try:
            predictor = drive(
                f"(d) main_test, {'graphs' if graphs else 'eager'}",
                lambda: cli_main_test.main(["--conf_file", conf_predict]),
                -(-N_TEST // 16))
        finally:
            trainer_mod.make_eval_step = factory
        step = predictor.eval_step
        n_graphs[graphs] = len(step) if isinstance(step, SignatureGraphs) else 0
        with open(os.path.join(folder, "submission.json")) as f:
            subs[graphs] = json.load(f)
        del predictor, step
    log(f"phase 12 (d): main_test submissions on graphs ({n_graphs[True]} "
        f"graphs) and eager ({n_graphs[False]}): {len(subs[True])} entries, "
        f"equal {subs[True] == subs[False]}")
    if not (subs[True] == subs[False] and len(subs[True]) == N_TEST
            and n_graphs[True] >= 1 and n_graphs[False] == 0):
        raise AssertionError("phase 12: main_test on graphs differs from "
                             "eager")


def profile_counts(fn):
    """One run of ``fn`` under torch.profiler: (wall ms, device-busy ms,
    device kernels, kernel-launch calls on the host, graph launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = kernels = launches = graphs = 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) == "DeviceType.CUDA":
            us = getattr(e, "self_device_time_total", None)
            busy += us if us is not None else getattr(e, "self_cuda_time_total", 0)
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
        elif e.key in LAUNCH_APIS:
            launches += e.count
        elif e.key == "cudaGraphLaunch":
            graphs += e.count
    return wall, busy / 1e3, kernels, launches, graphs


def host_ms_per_batch(engine, batches):
    """Host ms to enqueue one batch's forward and its score fetch (the
    device batches made first; each fetch awaited before the next)."""
    import torch

    blocks = [[engine.to_device(b) for b in batch] for batch in batches]
    torch.cuda.synchronize()
    out = []
    for b in blocks:
        t0 = time.perf_counter()
        fetch = engine._launch(b)
        out.append((time.perf_counter() - t0) * 1e3)
        fetch()
    return out


def graph_numbers(params, reqs, device="cuda"):
    """Phase 12 (e): graph path against eager for fp32 and BF16, in turns
    in one call (medians of 3): serve q/s, host ms per batch, device-busy
    share and launches per batch (profiler on). Returns the numbers."""
    n_batches = -(-N_REQUESTS // 16)
    numbers = {}
    for label, opts in (("fp32", {}), ("BF16", {"BF16": True})):
        g = build_engine("auto", params, device=device, **opts)[0]
        e = build_engine("auto", params, device=device, graphs=False,
                         **opts)[0]
        g.warmup_calibrated(reqs)
        e.predict(reqs)
        log(f"phase 12 (e): {label}: eager against graphs")
        qps, _ = in_turns("eager", lambda: e.predict(reqs), "graphs",
                          lambda: g.predict(reqs))
        batches = [b[:3] for _, _, b in e._collated_batches(reqs)]
        host = {"eager": [], "graphs": []}
        prof = {"eager": [], "graphs": []}
        for i in range(3):
            for arm in (("eager", "graphs") if i % 2 == 0
                        else ("graphs", "eager")):
                engine = e if arm == "eager" else g
                host[arm] += host_ms_per_batch(engine, batches)
                prof[arm].append(profile_counts(lambda: engine.predict(reqs)))
        row = {}
        for arm in ("eager", "graphs"):
            walls, busys = ([p[i] for p in prof[arm]] for i in (0, 1))
            share = statistics.median(100 * b / w for w, b in zip(walls, busys))
            _, _, kernels, launches, graph_launches = prof[arm][0]
            row[arm] = {"qps": statistics.median(qps[arm]),
                        "host_ms": statistics.median(host[arm]),
                        "busy_pct": share,
                        "busy_ms": statistics.median(busys),
                        "wall_ms": statistics.median(walls),
                        "kernels_per_batch": kernels / n_batches,
                        "launch_calls_per_batch": launches / n_batches,
                        "graph_launches_per_batch": graph_launches / n_batches}
            log(f"  {label} {arm}: serve {row[arm]['qps']:.2f} q/s; host "
                f"{row[arm]['host_ms']:.3f} ms per batch "
                f"{[round(x, 3) for x in host[arm]]}; device busy "
                f"{row[arm]['busy_ms']:.3f} of {row[arm]['wall_ms']:.3f} ms "
                f"({share:.1f}%, profiler on, median of 3); per batch "
                f"{row[arm]['kernels_per_batch']:.1f} device kernels, "
                f"{row[arm]['launch_calls_per_batch']:.1f} kernel-launch "
                f"calls, {row[arm]['graph_launches_per_batch']:.1f} graph "
                f"launches")
        numbers[label] = row
        del g, e
    return numbers


def phase12_rank(rank, world, address, work, device="cuda"):
    """One of two gloo ranks on the one card: the trainer at tp 2 under
    INT8_BERT (the int8 layers whole on each rank), its eval step on
    phase 10's batches; K1's head counts recorded."""
    import collections

    import numpy as np
    import torch.distributed as dist

    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from ruart_tpu_torch.utils.graphs import SignatureGraphs

    opt = dict(mesh_conf(work), INT8_BERT=True, coordinator_address=address,
               num_processes=world, process_id=rank, local_device_ids="0")
    maybe_initialize_distributed(opt, device, backend="gloo")
    batches, _ = load_mesh_batches(work)
    trainer = mesh_trainer(opt, device, 2)
    trainer._apply_int8_eval()
    heads = collections.Counter()
    rows = att.attention_rows

    def record_heads(q, k, v, bias, n_heads):
        heads[n_heads] += 1
        return rows(q, k, v, bias, n_heads)

    att.attention_rows = record_heads
    att.attention_rows_cuda.launches = 0
    att.sharded_fused_attention.launches = 0
    scores = [trainer.eval_step(*on_device(trainer, b))[0].cpu().numpy()
              for b in batches]
    att.attention_rows = rows
    with open(os.path.join(work, f"int8_rank_{rank}.json"), "w") as f:
        json.dump({"mesh": trainer.mesh.shape, "heads": dict(heads),
                   "k1": att.attention_rows_cuda.launches,
                   "sharded": att.sharded_fused_attention.launches,
                   "graphs": isinstance(trainer.eval_step, SignatureGraphs)},
                  f)
    np.savez(os.path.join(work, f"int8_rank_{rank}.npz"), *scores)
    dist.destroy_process_group()


def int8_tp_ranks(work, device="cuda"):
    """Phase 12 (f): ``INT8_BERT`` at tp 2 on two gloo ranks on the one
    card (eager: a mesh keeps the eval step eager), phase 10's weights and
    batches, against the single-process trainer's int8 eval step: scores
    within 1e-4, K1 over all 12 heads on each rank."""
    import numpy as np

    from ruart_tpu_torch.parallel.launch import spawn

    from ruart_tpu_torch.ops.quant import quantize_bert_params

    batches, _ = load_mesh_batches(work)
    single = mesh_trainer(dict(mesh_conf(work), INT8_BERT=True), device)
    # the ranks quantize their host copy, the single process its weights on
    # the card: the int8 weights and scales must come out bit-equal
    state = {k: v for k, v in single.model.state_dict().items()
             if k.startswith("Bert.")}
    here, host = (quantize_bert_params(s) for s in (
        state, {k: v.cpu() for k, v in state.items()}))
    apart = sum(int((here[k].cpu() != host[k]).sum()) for k in here)
    log(f"phase 12 (f): int8 weights and scales quantized on the card and "
        f"on the host: {apart} of {sum(v.numel() for v in here.values())} "
        f"values apart")
    if apart:
        raise AssertionError("phase 12: quantization differs by device")
    single._apply_int8_eval()
    want = [single.eval_step(*on_device(single, b))[0].cpu().numpy()
            for b in batches]
    del single
    t0 = time.time()
    spawn("chip_smoke:phase12_rank", 2, args=(work, device), timeout=300)
    wall = time.time() - t0
    failures = []
    for r in range(2):
        with open(os.path.join(work, f"int8_rank_{r}.json")) as f:
            st = json.load(f)
        with np.load(os.path.join(work, f"int8_rank_{r}.npz")) as z:
            got = [z[f"arr_{i}"] for i in range(len(batches))]
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        log(f"phase 12 (f): INT8_BERT rank {r}: mesh {st['mesh']}, K1 "
            f"{st['k1']} launches, heads per call {st['heads']}, sharded "
            f"calls {st['sharded']}, graphs {st['graphs']}; max |score - "
            f"single-process int8| {diff:.3e} (tol {SCORE_TOL:g})")
        layers = 12 * len(batches)
        if not (diff <= SCORE_TOL and st["mesh"] == {"dp": 1, "tp": 2}
                and st["heads"] == {"12": layers}
                and (st["k1"] == layers or device != "cuda")
                and st["sharded"] == 0 and not st["graphs"]):
            failures.append(f"rank {r}")
    log(f"phase 12 (f): 2 gloo ranks in {wall:.1f} s wall")
    if failures:
        raise AssertionError("phase 12: INT8_BERT at tp 2 disagrees on "
                             + ", ".join(failures))



# -- phase 13: the train step as one CUDA graph per batch signature ---------

N_GRAPH_STEPS = 10
N_GRAPH_BATCHES = 5   # the 10 steps take batches 0-4 twice: 5 replays or more
TRAIN_SEED = 0        # the dropout generator's seed in every arm
ARM_SPREAD = 2        # graph vs eager held to this many eager-vs-eager spreads
GRAPH_RUNS = 5        # runs of a graph arm whose median difference is held to it


def train_graph_cost(step):
    """Captures, seconds per capture (the signature's first call: its eager
    step and the capture) and graph pool bytes of a train step."""
    graphs = step.graphs
    seconds = sorted(g.seconds for g in graphs.graphs.values())
    return {"captures": len(graphs), "seconds": seconds,
            "pool_bytes": pool_bytes(graphs.pool)}


def train_arm(setup, opt, graphs: bool, device="cuda"):
    """One arm of phase 13 (a): a model of the conf ``opt`` from phase 6's
    trained weights, its optimizer and the dropout generator seeded with
    TRAIN_SEED, built through ``make_train_step(..., graphs=graphs)``.
    Returns (step, state, the batches of its N_GRAPH_STEPS steps)."""
    import torch

    from ruart_tpu_torch.core.config import Config
    from ruart_tpu_torch.models.fusion.model import RUArtModel
    from ruart_tpu_torch.models.fusion.spec import ModelSpec
    from ruart_tpu_torch.train.loss import make_loss_fn
    from ruart_tpu_torch.train.optim import Optimizer, make_row_pinner
    from ruart_tpu_torch.train.train_step import init_train_state, make_train_step

    spec = ModelSpec.from_config(Config(opt), setup["bert"])
    with torch.device(device):
        model = RUArtModel(spec)
    model.load_state_dict(setup["weights"])
    tune = int(opt["tune_partial"]) if "TUNE_PARTIAL" in opt else None
    tx = Optimizer(str(opt.get("optimizer", "#")), float(opt["lr"]),
                   float(opt.get("grad_clipping", 10)), model, spec,
                   tune is not None)
    step = make_train_step(make_loss_fn(str(opt.get("loss", "BCE_D1"))),
                           make_row_pinner(model, spec, tune), graphs=graphs)
    state = init_train_state(model, tx, TRAIN_SEED)
    batches = [setup["batches"][i % N_GRAPH_BATCHES]
               for i in range(N_GRAPH_STEPS)]
    return step, state, batches


def run_arm(step, state, batches):
    """The arm's steps; returns (losses, trainable parameters after)."""
    losses = [step(state, *b)[1] for b in batches]
    return ([float(x) for x in losses],
            {n: p.detach().clone() for n, p in state.optimizer.params.items()})


def rerun_arm(setup, step, state, batches, opt_state):
    """The arm's steps again from its start: the weights, the optimizer's
    moments and count (``opt_state``, its state before the first step) and
    the dropout generator reset in place, so a graph arm replays the graphs
    its first run captured and captures none."""
    state.model.load_state_dict(setup["weights"])
    state.optimizer.load_state_dict(opt_state)
    state.generator.manual_seed(TRAIN_SEED)
    state.step = 0
    return run_arm(step, state, batches)


def arm_diff(a, b):
    """(max relative loss difference over the steps, max and mean |param
    difference|) between two arms' results."""
    import torch

    loss = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    diffs = [(a[1][n] - b[1][n]).abs() for n in b[1]]
    top = max(d.max().item() for d in diffs)
    mean = (sum(d.sum().item() for d in diffs)
            / sum(d.numel() for d in diffs))
    return loss, top, mean


@contextlib.contextmanager
def deterministic_kernels():
    """PyTorch's deterministic kernels (embedding and index backward sorted
    instead of atomic, cuDNN's deterministic algorithms) inside the block."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def train_graph_equality(setup, drive, device="cuda"):
    """Phase 13 (a) and (b): per configuration, eager arms and a graph arm
    over the same 10 batches with dropout on. Eager training is not
    byte-stable on the card (the embedding and index backward add with
    atomics): its spread is measured first. The shipped conf and BF16 are
    byte-stable under PyTorch's deterministic kernels, which they capture:
    there the graph arm must be byte-equal to the eager one. LOCK_BERT off
    does not capture under them (the capture is invalidated: "operation not
    permitted when stream is capturing"), so there the median difference of
    GRAPH_RUNS runs of a graph arm (on the default kernels; the later runs
    reset it and replay its captures) from an eager arm stays within
    ARM_SPREAD times the largest spread of three eager arms: a single run's
    difference is one more draw from the spread the limit is taken from,
    and it failed the limit once with nothing wrong. K1 12 per step on both
    paths (replay-aware), in bf16 under BF16. Returns the fp32 arms for the
    timing."""
    base = dict(setup["opt"])
    confs = [("fp32", base, False, True),
             ("BF16", dict(base, BF16=True), True, True),
             ("LOCK_BERT off", {k: v for k, v in base.items()
                                if k != "LOCK_BERT"}, False, False)]
    failures, kept = [], {}
    for label, opt, bf16, exact in confs:
        def arm(graphs, driven=""):
            """One arm's results; a ``driven`` arm counts its launches,
            and the fp32 ones are kept for the timing."""
            step, state, batches = train_arm(setup, opt, graphs, device)
            if not driven:
                return run_arm(step, state, batches)
            if label == "fp32":
                kept[driven] = (step, state)
            return drive(f"13 (b) {label} {driven} steps",
                         lambda: run_arm(step, state, batches), N_GRAPH_STEPS,
                         bf16=bf16, exact=True)

        eager = [arm(False, "eager"), arm(False)]
        spread = arm_diff(eager[1], eager[0])
        log(f"phase 13 (a): {label}: eager vs eager: max rel loss diff "
            f"{spread[0]:.3e}, max |param diff| {spread[1]:.3e}, mean "
            f"{spread[2]:.3e}")
        if exact:
            got = arm(True, "graph")
            diff = arm_diff(got, eager[0])
            with deterministic_kernels():
                det = [arm(False), arm(False), arm(True)]
            det_spread, det_diff = (arm_diff(det[i], det[0]) for i in (1, 2))
            ok = det_spread == det_diff == (0.0, 0.0, 0.0)
            tol = (f"byte-equal under deterministic kernels: eager vs eager "
                   f"{det_spread}, graphs vs eager {det_diff}")
        else:
            eager.append(arm(False))
            spread = tuple(max(x) for x in zip(
                spread, arm_diff(eager[2], eager[0]),
                arm_diff(eager[2], eager[1])))
            step, state, batches = train_arm(setup, opt, True, device)
            opt_state = state.optimizer.state_dict()
            runs = [drive(f"13 (b) {label} graph steps",
                          lambda: run_arm(step, state, batches),
                          N_GRAPH_STEPS, bf16=bf16, exact=True)]
            captures = len(step.graphs)
            runs += [rerun_arm(setup, step, state, batches, opt_state)
                     for _ in range(GRAPH_RUNS - 1)]
            got = runs[0]
            diffs = [arm_diff(r, eager[0]) for r in runs]
            diff = tuple(statistics.median(d[i] for d in diffs)
                         for i in range(3))
            limit = tuple(ARM_SPREAD * x for x in spread)
            ok = (all(d <= t for d, t in zip(diff, limit))
                  and len(step.graphs) == captures)
            margins = [d / t if t else math.inf * (d > 0)
                       for d, t in zip(diff, limit)]
            tol = (f"the median of {GRAPH_RUNS} runs of the graph arm ("
                   + "; ".join(", ".join(f"{x:.3e}" for x in d) for d in diffs)
                   + f"; {captures} captures, {len(step.graphs) - captures} "
                   f"more in the reruns) within {ARM_SPREAD} x the largest "
                   "spread of 3 eager arms: "
                   + ", ".join(f"{x:.3e}" for x in limit)
                   + "; margin (value / limit) "
                   + ", ".join(f"{x:.2f}" for x in margins))
            del step, state
        log(f"phase 13 (a): {label}: losses eager "
            f"{[round(x, 6) for x in eager[0][0]]}, graphs "
            f"{[round(x, 6) for x in got[0]]}")
        log(f"phase 13 (a): {label}: graphs vs eager: max rel loss diff "
            f"{diff[0]:.3e}, max |param diff| {diff[1]:.3e}, mean "
            f"{diff[2]:.3e}; tol {tol}; {'ok' if ok else 'FAILED'}")
        if not ok:
            failures.append(label)
    if failures:
        raise AssertionError("phase 13: the graph steps disagree with the "
                             "eager steps in " + ", ".join(failures))
    return kept


N_DROPPED_ARMS = 3  # phase 13 (f)
CUPTI_VARIABLES = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


def dropped_graph_arms(setup, drive, device="cuda"):
    """Phase 13 (f), run between (a) and (c): N_DROPPED_ARMS LOCK_BERT-off
    train steps built with ``make_train_step(graphs=True)``, each run for
    its N_GRAPH_STEPS steps (K1 12 per step, replay-aware) and dropped
    (their graphs freed at the ``del``). Then (c) replays the kept fp32
    graph arm under the profiler: the input under which such a replay
    segfaulted inside CUPTI while the dropped arms' graphs were left to
    the cyclic collector (ROADMAP Queue 3)."""
    opt = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}
    t0 = time.time()
    captures = []
    for i in range(N_DROPPED_ARMS):
        step, state, batches = train_arm(setup, opt, True, device)
        drive(f"13 (f) LOCK_BERT off graph arm {i}, dropped",
              lambda: run_arm(step, state, batches), N_GRAPH_STEPS,
              exact=True)
        captures.append(len(step.graphs))
        del step, state
    log(f"phase 13 (f): {N_DROPPED_ARMS} LOCK_BERT-off graph arms built, run "
        f"for {N_GRAPH_STEPS} steps each and dropped before (c): captures "
        f"{captures}, {time.time() - t0:.1f} s; CUPTI "
        + ", ".join(f"{k}={os.environ.get(k)}" for k in CUPTI_VARIABLES))


def train_graph_timing(arms, setup):
    """Phase 13 (b) host calls and (c): the fp32 arms in turns, 3 rounds of
    10 synchronized steps each (the median per round), and one profiled
    step per arm and round (device-busy share, device kernels, kernel-launch
    calls and graph launches on the host). Returns the numbers."""
    import torch

    runs = {"eager": arms["eager"], "graphs": arms["graph"]}
    batches = [setup["batches"][i % N_GRAPH_BATCHES]
               for i in range(N_GRAPH_STEPS)]
    medians = {arm: [] for arm in runs}
    prof = {arm: [] for arm in runs}
    for i in range(3):
        for arm in (("eager", "graphs") if i % 2 == 0 else ("graphs", "eager")):
            step, state = runs[arm]
            times = []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, *b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            medians[arm].append(statistics.median(times))
            prof[arm].append(profile_counts(lambda: step(state, *batches[0])))
    numbers = {}
    for arm in runs:
        walls, busys = ([p[i] for p in prof[arm]] for i in (0, 1))
        _, _, kernels, launches, graph_launches = prof[arm][0]
        numbers[arm] = {
            "step_ms": statistics.median(medians[arm]),
            "rounds_ms": medians[arm],
            "busy_pct": statistics.median(100 * b / w
                                          for w, b in zip(walls, busys)),
            "busy_ms": statistics.median(busys),
            "wall_ms": statistics.median(walls), "kernels": kernels,
            "launch_calls": launches, "graph_launches": graph_launches}
        n = numbers[arm]
        log(f"phase 13 (c): {arm}: step median {n['step_ms']:.3f} ms (rounds "
            f"{[round(x, 3) for x in medians[arm]]}, each the median of "
            f"{len(batches)} synchronized steps); profiled step busy "
            f"{n['busy_ms']:.3f} of {n['wall_ms']:.3f} ms ({n['busy_pct']:.1f}%, "
            f"profiler on, median of 3); per step {kernels} device kernels, "
            f"{launches} kernel-launch calls, {graph_launches} "
            f"graph launches")
    return numbers


def released_between_sessions(kept, engine, reqs, owners, drive, label):
    """Graphs released between two profiler sessions, then surviving graphs
    replayed in the second: phase 13 (g), and with more owners
    ``tools/torch_train_graph_crash.py --form release``. ``kept``: (train
    step, its state, a batch whose graph is captured); ``engine``: a graph
    engine whose signatures of ``reqs`` are captured; ``owners``: (name,
    graphs, release) per owner, ``graphs()`` giving the ``SignatureGraphs``
    whose graphs go and ``release()`` freeing them through the port's API.
    Each session replays the kept train graph (one step) and the engine's
    eval graphs (one ``predict``), K1 12 per step or batch by ``drive``;
    between them, outside any session, every owner releases. Returns
    (graphs destroyed at the releases, graphs the owners held, graph
    launches in each session)."""
    import weakref

    step, state, batch = kept
    n = 1 + -(-len(reqs) // engine.batch_size)
    captured = (len(step.graphs), engine.graph_count)

    def replays(session):
        return drive(f"{label} session {session}: kept train and eval graphs",
                     lambda: (step(state, *batch), engine.predict(reqs)), n,
                     exact=True)

    launches = [profile_counts(lambda: replays(1))[4]]
    destroyed = held = 0
    for name, graphs, release in owners:
        refs = [weakref.ref(g.graph) for g in graphs().graphs.values()]
        release()
        gone = sum(r() is None for r in refs)
        log(f"{label}: {name}: {gone} of {len(refs)} graphs destroyed "
            f"between the sessions")
        destroyed, held = destroyed + gone, held + len(refs)
    launches.append(profile_counts(lambda: replays(2))[4])
    log(f"{label}: {destroyed} of {held} graphs destroyed between two "
        f"profiler sessions; graph launches in the sessions {launches} "
        f"(profiler); {n} replays in each, one of the kept train graph "
        f"and {n - 1} of eval graphs (by K1's count)")
    if (len(step.graphs), engine.graph_count) != captured:
        raise AssertionError(f"{label}: the kept steps captured anew")
    return destroyed, held, launches


def released_graphs(arms, setup, drive, device="cuda"):
    """Phase 13 (g), after (c): a graph engine's signatures captured and a
    LOCK_BERT-off graph train step run for its 10 steps; the first profiler
    session replays the kept fp32 graph arm and the engine's eval graphs;
    outside any session the train step is released (``TrainStep.release``)
    and dropped; the second session replays both again. The train step's
    graphs must all be gone before the second session."""
    reqs = requests()
    engine = build_engine("auto", setup["params"], device=device)[0]
    engine.predict(reqs)  # captures this pass's signatures
    opt = {k: v for k, v in setup["opt"].items() if k != "LOCK_BERT"}
    held = {"arm": train_arm(setup, opt, True, device)}
    step, state, batches = held["arm"]
    drive("13 (g) LOCK_BERT off graph arm, released",
          lambda: run_arm(step, state, batches), N_GRAPH_STEPS, exact=True)
    del step, state

    def release():
        held.pop("arm")[0].release()

    t0 = time.time()
    destroyed, n_graphs, _ = released_between_sessions(
        (*arms["graph"], setup["batches"][0]), engine, reqs,
        [("a LOCK_BERT-off graph train step, released and dropped",
          lambda: held["arm"][0].graphs, release)], drive, "phase 13 (g)")
    log(f"phase 13 (g): {time.time() - t0:.1f} s for the two sessions and "
        f"the release")
    if not destroyed == n_graphs > 0:
        raise AssertionError("phase 13: a released train step kept graphs")


def generator_registration():
    """Phase 13 (e): a graph that registers the dropout generator draws, at
    each replay, what eager draws from the same generator state; a capture
    that uses an unregistered generator raises, naming the signature."""
    import torch

    from ruart_tpu_torch.utils.graphs import SignatureGraphs

    x = torch.zeros(4096, device="cuda")
    got, want = [], []
    for arm, out in (("graph", got), ("eager", want)):
        g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)

        def draw(x, g=g):
            return torch.empty_like(x).bernoulli_(0.7, generator=g)

        fn = SignatureGraphs(draw, "cuda", generators=(g,)) if arm == "graph" else draw
        out += [fn(x).clone() for _ in range(4)]
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    distinct = len({tuple(t[:64].tolist()) for t in want}) == len(want)
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    unregistered = SignatureGraphs(
        lambda x: torch.empty_like(x).bernoulli_(0.7, generator=g), "cuda")
    try:
        unregistered(x)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    log(f"phase 13 (e): 4 draws of a registered generator, graph (1 eager "
        f"call, 3 replays) against eager: equal {same}, each draw new "
        f"{distinct}; an unregistered generator: "
        + (f"raised {raised[:160]!r}" if raised else "did NOT raise"))
    if not (same and distinct and "capture failed for signature" in raised):
        raise AssertionError("phase 13: the dropout generator's graph "
                             "handling is wrong")


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
    if sys.argv[1:] not in ([], ["--cupti-default"]):
        print("usage: chip_smoke.py [--cupti-default]", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    faulthandler.enable()  # a crash in native code prints the Python stack
    if sys.argv[1:]:  # --cupti-default: neither variable set, whatever
        for name in CUPTI_VARIABLES:  # the environment holds
            os.environ.pop(name, None)
    return run()


def run(phase13=None, skip=()) -> int:
    """Phases 1-13 in order, then the kernels line and the last line.

    ``phase13(graph_setup, drive)``, when given, runs in place of phase 13
    and the report (``tools/torch_train_graph_crash.py --form smoke``),
    with ``skip`` naming phases of 1, 4, 5, 7, 8, 9, 10, 11 and 12 left
    out; phases 2, 3 and 6 make what the later ones take, and phase 11
    reads files phase 9 writes."""
    import torch

    from ruart_tpu_torch.models.bert.model import BertSelfAttention
    from ruart_tpu_torch.ops import attention as att
    from ruart_tpu_torch.ops import gemm, moe

    def reset_counts():
        att.sharded_fused_attention.launches = 0
        att.attention_rows_cuda.launches = 0
        att.attention_rows_cuda.bf16_launches = 0
        att.flash_attention_cuda.launches = 0
        gemm.linear_cuda.launches = 0

    def counts():
        return {"K1": att.attention_rows_cuda.launches,
                "K1 bf16": att.attention_rows_cuda.bf16_launches,
                "K3": att.flash_attention_cuda.launches,
                "G1": gemm.linear_cuda.launches}

    driven = []  # phases 8 and 9: (path, launches, batches or steps)

    def drive(label, fn, batches, bf16=False, exact=False):
        """Run one path with the counts set to 0 just before and read just
        after. K1 must launch 12 times per batch or step: exactly with
        ``exact``, else at least (where the path also warms up or
        evaluates); all of them in bf16 when ``bf16``, none in bf16
        otherwise. ``batches``: a count, or a function of ``fn``'s
        result."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launched = counts()
        n = batches(out) if callable(batches) else batches
        driven.append((label, launched, n))
        k1, b16 = launched["K1"], launched["K1 bf16"]
        ok = k1 == 12 * n if exact else k1 >= 12 * n
        if not (ok and b16 == (k1 if bf16 else 0)):
            raise AssertionError(f"{label} launched K1 {k1} times ({b16} in "
                                 f"bf16) for {n} batches or steps")
        # G1 takes the fp32 encoder's Linears only: none under BF16 or
        # INT8_BERT
        if (bf16 or "int8" in label.lower()) and launched["G1"]:
            raise AssertionError(f"{label} launched G1 {launched['G1']} "
                                 "times")
        return out

    t_start = time.time()
    card = card_line()
    log(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")

    # -- phase 1: build + kernel against plain ------------------------------
    if 1 not in skip:
        t0 = time.time()
        report = att.build_kernel(force=True)
        log(f"phase 1: built {att.LIBRARY.name} from "
            f"{', '.join(s.name for s in att.SOURCES)} in {time.time() - t0:.1f} s")
        ptxas_report(report)
        lib = att._library()
        for name, (L, dh, bias_2d, flash) in (("K1", (SERVE_SHAPE[1], 64, 1, 0)),
                                              ("K2", (K2_SHAPE[1], 48, 1, 0)),
                                              ("K3", (FLASH_SHAPES[0][2], 64, 0, 1))):
            log(f"  {name} fp32 at L {L}, dh {dh}: "
                f"{lib.ruart_attention_blocks_per_sm(L, dh, 0, bias_2d, flash)} "
                f"blocks resident per SM")
        for B, L, H, dh, bias_2d in (SERVE_SHAPE, CHUNK_SHAPE):
            log(f"  K1 bf16 at L {L}, dh {dh}: "
                f"{lib.ruart_attention_bf16_blocks_per_sm(L, dh, int(bias_2d))} "
                f"blocks resident per SM")
        errs = check_kernel(att)
        race_check(att)
        sanitize(report)
        g1_errs = check_gemm(gemm)
        g1 = time_gemm(gemm)
        log(f"G1, one encoder layer's 4 launches at {G1_TOKENS[0]} tokens, "
            f"hot in L2: kernel {g1[0]:.4f} ms, plain {g1[1]:.4f} ms, FFMA "
            f"F.linear {g1[2]:.4f} ms; bound {g1[3]:.4f} ms (operations): "
            f"kernel at {100 * g1[3] / g1[0]:.1f}% of its bound")
        moon_errs = check_moonlight(att, moe)
        moon = time_moonlight(att, moe)
        _, moon_launches, moon_calls = moonlight_evaluate()
        log(f"phase 1 ok: worst fp32 error K1 {errs['K1']:.3e}, K2 {errs['K2']:.3e}")

    # -- phase 2: serve at full width (main path 1) ---------------------------
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
    reset_counts()
    results = engine.predict(reqs)
    torch.cuda.synchronize()
    serve_counts = counts()
    for h in hooks:
        h.remove()
    n_batches = -(-N_REQUESTS // engine.batch_size)
    log(f"phase 2: {len(results)} answers, launches {serve_counts} over "
        f"{n_batches} batches; attention shapes (rows, L, heads, dh, "
        f"segment) x calls: {dict(shapes)}")
    if len(results) != N_REQUESTS or not all(
        isinstance(r["answer"], str) and r["answer"]
        and math.isfinite(r["score"]) for r in results
    ):
        raise AssertionError(f"bad serving results: {results}")
    if serve_counts["K1"] < 12 * n_batches:
        raise AssertionError(f"attention kernel launched {serve_counts['K1']} "
                             f"times, expected >= {12 * n_batches}")
    # G1: Q/K/V joined, attention output, intermediate, output: 4 a layer
    if serve_counts["G1"] != 4 * serve_counts["K1"]:
        raise AssertionError(f"G1 launched {serve_counts['G1']} times for "
                             f"{serve_counts['K1']} encoder layers")
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
    k1 = time_kernel(att, shape)
    log_timing("K1", shape, k1)
    k2 = time_kernel(att, K2_SHAPE)
    log_timing("K2", K2_SHAPE, k2)

    # -- phase 3: the same batches through the plain version -----------------
    plain, _ = build_engine("plain", params)
    got = batch_scores(engine, reqs)
    diff = max_diff(got, batch_scores(plain, reqs))
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
    del engine, plain

    # -- phase 4: K3 against its plain version --------------------------------
    if 4 not in skip:
        k3_err = check_flash(att)
        k3 = time_flash(att)
        log_timing("K3", FLASH_SHAPES[0], k3)
        log(f"phase 4 ok: K3 worst fp32 error {k3_err:.3e}")

    # -- phase 5: K1's autograd.Function -------------------------------------
    if 5 not in skip:
        check_autograd(att)

    # -- phase 6: train and predict through the CLIs (main paths 2 and 3) -----
    # the run's data and run folders live in the checkout's ignored scratch
    os.makedirs(os.path.join(HERE, "_scratch"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_", dir=os.path.join(HERE, "_scratch"))
    try:
        t0 = time.time()
        conf = write_training_data(root)
        log(f"phase 6: wrote {N_TRAIN}/{N_VAL}/{N_TEST} synthetic items in "
            f"{time.time() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        trainer, steps = run_training(att, conf)
        torch.cuda.synchronize()
        train_counts = counts()
        train_wall = time.time() - t0
        losses = [float(loss) for _, _, loss in steps]
        per_step = [n for n, _, _ in steps]
        folder = os.path.join(root, "conf~", "run_1")
        layers = trainer.spec.bert.num_hidden_layers
        log(f"phase 6: CLI train {train_wall:.1f} s wall, {trainer.updates} "
            f"steps, launches {train_counts}, K1 launches per step "
            f"{sorted(set(per_step))}, losses {[round(x, 5) for x in losses]}")
        if not (len(steps) == trainer.updates == N_TRAIN // trainer.cfg.batch_size):
            raise AssertionError(f"expected {N_TRAIN // 16} steps, ran {len(steps)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("a training loss is not finite")
        if min(per_step) < layers:
            raise AssertionError("a train step ran without the attention kernel")
        for name in ("ANLS_best_model.ckpt", "ACC_best_model.ckpt", "conf_copy"):
            if not os.path.isfile(os.path.join(folder, name)):
                raise AssertionError(f"the run folder lacks {name}")
        steps_per_s = trainer.updates / trainer.train_seconds
        peak_train = torch.cuda.max_memory_allocated()
        # read at the trainer's release; now for a port whose trainer does
        # not release (torch_train_graph_crash.py --root)
        train_cost = (trainer.train_step.cost
                      or train_graph_cost(trainer.train_step.step))
        log(f"phase 6: the train step on CUDA graphs: {train_cost['captures']} "
            f"captures in {len(steps)} steps, seconds per capture "
            f"{[round(x, 4) for x in train_cost['seconds']]}, graph pool "
            f"{train_cost['pool_bytes']} bytes")
        eval_graph_after_training(trainer)
        [batch] = train_batches_on_device(trainer)
        step_ms, step_times = time_train_steps(trainer, batch)
        log(f"phase 6: train step median {step_ms:.2f} ms (synchronized, "
            f"{[round(t, 2) for t in step_times]}); CLI loop {steps_per_s:.3f} "
            f"steps/s over {trainer.train_seconds:.2f} s; peak device memory "
            f"{peak_train / 2**30:.3f} GiB")
        profile_device(lambda: [trainer.train_step(trainer.state, *batch)
                                for _ in range(3)], "3 train steps")
        for e in trainer.eval_history:
            log(f"  eval {e['mode']} batch {e['batch']}: {e['n']} items in "
                f"{e['seconds']:.3f} s ({e['n'] / e['seconds']:.2f} q/s), "
                f"ANLS {e['ANLS']:.4f} ACC {e['ACC']:.4f}")

        # what phase 13 trains from: the trained weights, 5 batches
        graph_setup = {
            "opt": dict(trainer.opt), "bert": trainer.spec.bert,
            "params": params,  # the serving weights, for 13 (g)'s engine
            "weights": {k: v.detach().clone()
                        for k, v in trainer.model.state_dict().items()},
            "batches": train_batches_on_device(trainer, N_GRAPH_BATCHES)}

        # -- phase 7: one step with the kernel and with the plain version -----
        if 7 not in skip:
            compare_plain_step(att, trainer, batch)
        del trainer, batch

        from ruart_tpu_torch.cli import main_test as cli_main_test

        predict = os.path.join(root, "conf_predict")
        with open(conf) as f, open(predict, "w") as g:
            g.write("RESUME\nMODEL_PATH\tconf~/run_1/ANLS_best_model.ckpt\n"
                    + f.read())
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        predictor = cli_main_test.main(["--conf_file", predict])
        torch.cuda.synchronize()
        predict_counts = counts()
        with open(os.path.join(folder, "submission.json")) as f:
            sub = json.load(f)
        last = predictor.eval_history[-1]
        first_qps = last["n"] / last["seconds"]
        # the CLI's pass is the model's first on new shapes; time three more,
        # warm passes of the same evaluator over the same test split (host
        # clock on a shared host: the median of the three)
        from ruart_tpu_torch.eval.evaluator import evaluate

        test_data = predictor._dataset(predictor._load_split("test"), "test")
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate(predictor.eval_step, test_data, predictor.cfg,
                     predictor.spec, predictor.device, predictor.collator)
            warm.append(len(test_data) / (time.perf_counter() - t0))
        eval_qps = statistics.median(warm)
        log(f"phase 6: CLI predict {len(sub)} answers, launches "
            f"{predict_counts}, eval {last['n']} items in {last['seconds']:.3f} s "
            f"({first_qps:.2f} q/s, first pass), warm passes "
            f"{[round(x, 2) for x in warm]} q/s (median {eval_qps:.2f}), "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if len(sub) != N_TEST or not all(isinstance(r["answer"], str) for r in sub):
            raise AssertionError(f"submission.json holds {len(sub)} entries, "
                                 f"expected {N_TEST}")
        if predict_counts["K1"] < layers * -(-N_TEST // 16):
            raise AssertionError("prediction ran without the attention kernel")
        log(f"phase 6 ok: median step {step_ms:.2f} ms, {steps_per_s:.3f} steps/s, "
            f"eval {eval_qps:.2f} q/s, peak train memory {peak_train} bytes")
        del predictor, test_data

        # -- phase 8: the serving stack (main paths 4 and on) ------------------
        if 8 not in skip:
            t0 = time.time()
            serve_stack(params, reqs, results, drive)
            serve_clis(folder, predict, reqs, drive)
            for label, launched, n in driven:
                log(f"  phase 8 path {label}: {n} batches, launches {launched}")
            log(f"phase 8 ok in {time.time() - t0:.1f} s")
        n_phase8 = len(driven)

        # -- phase 9: BF16, INT8+BF16, the other conf branches --------------
        if 9 not in skip:
            t0 = time.time()
            bf16_serving(params, reqs, drive)
            k1_bf16 = time_kernel(att, shape, "bfloat16")
            log_timing("K1 bf16", shape, k1_bf16)
            log_timing("K1 bf16 (for information)", CHUNK_SHAPE,
                       time_kernel(att, CHUNK_SHAPE, "bfloat16"))
            bf16_training(att, root, conf, drive)
            branch_forwards(reqs, root, drive)
            for label, launched, n in driven[n_phase8:]:
                log(f"  phase 9 path {label}: {n} batches or steps, launches "
                    f"{launched}")
            log(f"phase 9 ok in {time.time() - t0:.1f} s")

        # -- phase 10: the (dp, tp) mesh ------------------------------------
        if 10 not in skip:
            t0 = time.time()
            sharded_err = check_sharded_attention(att)
            k1_shards = {}
            for n_heads in (6, 3):
                shard = (SERVE_SHAPE[0], SERVE_SHAPE[1], n_heads) + SERVE_SHAPE[3:]
                k1_shards[n_heads] = time_kernel(att, shard)
                log_timing(f"K1 on a tp shard of {n_heads} heads", shard,
                           k1_shards[n_heads])
            nccl_world_of_one()
            engine, _ = build_engine("auto", params)
            sharded_launches = mesh_ranks(att, root, engine, params, got)
            del engine
            log(f"phase 10 ok in {time.time() - t0:.1f} s")

        # -- phase 11: PHOC, native host code, chunked BERT, attention maps --
        n_phase10 = len(driven)
        if 11 not in skip:
            t0 = time.time()
            engine, _ = build_engine("auto", params)
            words = native_host(engine, reqs)
            phoc_paths(words, reqs, root, conf, drive)
            k1_chunk = chunked_bert(att, params, engine, reqs, drive)
            attention_maps(engine, reqs, root, drive)
            del engine
            for label, launched, n in driven[n_phase10:]:
                log(f"  phase 11 path {label}: {n} batches or steps, launches "
                    f"{launched}")
            log(f"phase 11 ok in {time.time() - t0:.1f} s (K1 at the chunk's "
                f"shape {k1_chunk[0]:.4f} ms)")

        # -- phase 12: the eval step as one CUDA graph per signature --------
        n_phase11 = len(driven)
        if 12 not in skip:
            t0 = time.time()
            graph_answers = graphs_against_eager(params, reqs, drive)
            warm_graphs(params, reqs, drive)
            graph_server(params, reqs, graph_answers, drive)
            main_test_graphs(folder, predict, drive)
            graph_numbers(params, reqs)
            int8_tp_ranks(root)
            for label, launched, n in driven[n_phase11:]:
                log(f"  phase 12 path {label}: {n} batches or steps, launches "
                    f"{launched}")
            log(f"phase 12 ok in {time.time() - t0:.1f} s")

        # -- phase 13: the train step as one CUDA graph per signature -------
        t0 = time.time()
        n_phase12 = len(driven)
        if phase13 is not None:
            phase13(graph_setup, drive)
            return 0
        arms = train_graph_equality(graph_setup, drive)
        dropped_graph_arms(graph_setup, drive)
        train_graph_timing(arms, graph_setup)
        released_graphs(arms, graph_setup, drive)
        del arms, graph_setup
        log(f"phase 13 (d): phase 6's 20 steps through cli.main: "
            f"{train_cost['captures']} captures, seconds per capture "
            f"{[round(x, 4) for x in train_cost['seconds']]} (median "
            f"{statistics.median(train_cost['seconds']):.4f}), train graph "
            f"pool {train_cost['pool_bytes']} bytes")
        generator_registration()
        for label, launched, n in driven[n_phase12:]:
            log(f"  phase 13 path {label}: {n} steps, launches {launched}")
        log(f"phase 13 ok in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    (stack_counts, branch_counts, phase11_counts, phase12_counts,
     phase13_counts) = (
        {k: sum(c[k] for _, c, _ in paths) for k in serve_counts}
        for paths in (driven[:n_phase8], driven[n_phase8:n_phase10],
                      driven[n_phase10:n_phase11],
                      driven[n_phase11:n_phase12], driven[n_phase12:]))
    main_path = {k: serve_counts[k] + train_counts[k] + predict_counts[k]
                 + stack_counts[k] + branch_counts[k] + phase11_counts[k]
                 + phase12_counts[k] + phase13_counts[k] for k in serve_counts}
    log(f"launches on the main paths: serve {serve_counts}, train "
        f"{train_counts}, predict {predict_counts}, serving stack "
        f"{stack_counts}, phase 9 {branch_counts}, phase 11 {phase11_counts}, "
        f"phase 12 {phase12_counts}, phase 13 {phase13_counts}")
    log(f"total {time.time() - t_start:.1f} s")
    log(card)

    def entry(name, replaces, launches, err, timing,
              source="ruart_tpu_torch/csrc/attention.cu"):
        ms, plain_ms, lib_ms, bound_ms, bound_by, _ = timing
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    log(json.dumps({"kernels": [
        entry("attention_rows (K1, _packed_kernel)",
              "ruart_tpu/ops/attention.py:100",
              main_path["K1"] - main_path["K1 bf16"], errs["K1"], k1),
        # K1 on bf16 inputs, a kernel of its own: the BF16 paths
        entry("attention_rows (K1, _packed_kernel) bf16",
              "ruart_tpu/ops/attention.py:100", main_path["K1 bf16"],
              errs["K1 bf16"], k1_bf16,
              source="ruart_tpu_torch/csrc/attention_bf16.cu"),
        # K2's function runs in K1's kernels (timed here in fp32); no
        # main-path call has a head width that takes it at BERT-base (dh 64)
        entry("attention_rows (K2, _grouped_kernel)",
              "ruart_tpu/ops/attention.py:54", 0, errs["K2"], k2),
        entry("flash_attention (K3, _mha_kernel)",
              "ruart_tpu/ops/attention.py:36", main_path["K3"], k3_err, k3),
        # K1 on one rank's 6 local heads of a tp-2 shard; launches: the
        # sharded calls of the two ranks of phase 10 (c)
        entry("sharded_fused_attention (K1 on a tp shard's local heads)",
              "ruart_tpu/ops/attention.py:314", sharded_launches,
              sharded_err, k1_shards[6]),
        # no TPU kernel: the JAX package leaves these products to XLA
        dict(entry("linear (G1, the encoder's six Linears in fp32)",
                   "none (XLA's dot in ruart_tpu/models/bert/model.py)",
                   main_path["G1"], g1_errs[2], g1,
                   source="ruart_tpu_torch/csrc/gemm_tf32x3.cu"),
             # the worst error against fp64 over the sum's scale |x||w|^T
             max_scaled_err=g1_errs[1]),
        # no TPU kernel: the JAX package has no expert layer; launches:
        # the three evaluate passes of phase 1 (i) over the Moonlight
        # encoder (route, permute and combine beside the grouped GEMM)
        {"name": "grouped expert GEMM (gate/up + down, one layer at 4,352 "
                 "tokens, top 6 of 64)", "route": "cuda",
         "source": "ruart_tpu_torch/csrc/moe_bf16.cu", "replaces": "none",
         "launches": moon_launches["grouped GEMM"],
         "launches_route_permute_combine": [
             moon_launches[k] for k in ("route", "permute", "combine")],
         "encoder_calls": moon_calls,
         "max_err_over_scale": moon_errs[0],
         "ms": moon["gate_up"] + moon["down"], "plain_ms": moon["plain"],
         "bound_ms": moon["bound_ms"]},
        {"name": "attention_rows bf16 at 192/128 (the latent attention)",
         "route": "cuda", "source": "ruart_tpu_torch/csrc/attention_bf16.cu",
         "replaces": "none", "launches": moon_launches["192/128 attention"],
         "encoder_calls": moon_calls, "max_abs_err": moon_errs[1],
         "ms": moon["mla_ms"], "plain_ms": moon["mla_plain"],
         "bound_ms": moon["mla_bound"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
