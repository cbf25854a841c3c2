"""Online batched inference — port of ``ruart_tpu/serve.py``.

:class:`InferenceEngine` takes raw requests (question text + OCR tokens
with pixel boxes + object detections), runs the host featurization
pipeline, collates fixed-shape batches (padding the tail batch by
repeating its last item), runs the RUArt forward on the device and
decodes one answer per request. ``predict`` overlaps the host work of
batch N+1 with the device work of batch N; ``prepare``/``dispatch``/
``decode_pending`` split one wave into its host, device and decode stages
for :class:`BatchingServer`, the micro-batching front end. ``num_worker``
featurizes in a fork pool, ``quantize`` switches to the weight-only int8
encoder (INT8_BERT), ``warmup``/``warmup_calibrated`` run the eval step
once on every batch signature the JAX package would compile.

The engine serves through ``train.train_step.make_eval_step``, as the JAX
engine serves through its jitted eval step: on a card each batch signature
is captured once as a CUDA graph (by the warmups, or at its first live
batch) and every batch after is one replay. ``graphs=False`` keeps the
model eager (the port's ``jax.disable_jit``); on the CPU it is eager.

Request schema (one sample):
    {"question": str,
     "image_width": int, "image_height": int,
     "ocr": [{"word": str, "pos": [8 px quad]}...],
     "od":  [{"object": str, "pos": [cx, cy, w, h] px}...],
     "es":  optional [{"word", "pos", "cnt"}...]}

The engine runs on CUDA unless the caller passes ``device="cpu"``; without
a card it raises. On CUDA fp32 means full fp32: TF32 is turned off for
matmuls and for cuDNN (which also runs the LSTMs), and bf16 products (the
``BF16`` encoder) sum in fp32. Under ``BF16`` the engine's frozen encoder
keeps one bf16 copy of its projection weights, made at load
(``BertModel.cache_compute_weights``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import multiprocessing
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data.collate import (
    COMPACT_KEYS,
    DEDUP_KEYS,
    Collator,
    narrow_block,
    slim_block,
)
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.pipeline import fetch_async, host_block, prefetch, put_block
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_batch
from ruart_tpu_torch.eval.decoder import decode_batch
from ruart_tpu_torch.models.fusion.model import RUArtModel
from ruart_tpu_torch.models.fusion.spec import ModelSpec
from ruart_tpu_torch.ops.quant import quantize_bert_params
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer
from ruart_tpu_torch.train.train_step import make_eval_step
from ruart_tpu_torch.utils.gctune import tune_gc
from ruart_tpu_torch.utils.graphs import SignatureGraphs

log = logging.getLogger(__name__)

_ZERO8 = [0] * 8
_ZERO4 = [0, 0, 0, 0]

# fork-inherited engine for the serving `num_worker` process pool (the
# copy-on-write pattern of data/pipeline.py's pool): bound while the pool
# lives. Workers only featurize (python/numpy): a forked child never calls
# a torch op — torch's intra-op thread pool and CUDA do not survive a fork.
_FORK_ENGINE: Optional["InferenceEngine"] = None


def _fork_serve_items(job):
    base, chunk = job
    return _FORK_ENGINE._build_items(chunk, base)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the
    port has no silent CPU path. On CUDA, fp32 stays full fp32: TF32 is
    turned off for matmuls and for cuDNN (which also runs the LSTMs); bf16
    matmuls reduce in fp32, as the TPU sums them."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU (RUART_PLATFORM=cpu for the command-line tools)"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


class InferenceEngine:
    def __init__(
        self,
        cfg: Config,
        spec: ModelSpec,
        params: Mapping[str, Any],
        vocab: Sequence[str],
        tokenizer: WordPieceTokenizer,
        fixed_answers: Optional[Sequence[str]] = None,
        device=None,
        graphs: bool = True,
    ):
        """``params``: the state dict of ``RUArtModel(spec)`` (tensors or
        numpy arrays), e.g. ``convert.from_jax_params(flax_params)``.
        ``fixed_answers``: the answer list of a ``fixed_answers`` model (the
        trainer's ``fixed_answers``), for decoding. ``graphs``: replay one
        CUDA graph per batch signature on a card (the default), or run the
        model eagerly."""
        self.cfg = cfg
        self.spec = spec
        self.tokenizer = tokenizer
        self.fixed_answers = fixed_answers
        self.device = resolve_device(device)
        self.graphs = graphs
        self.collator = Collator(cfg)
        self.batch_size = cfg.batch_size
        # the serving host path is allocation-bound: raise GC thresholds
        # (NO_GC_TUNE conf key opts out)
        tune_gc(cfg.opt)
        self._pre = Preprocessor(cfg)
        self._pre.train_vocab = list(vocab)
        self._pre.gram_word_keys = ("word", "wordid", "pos_id", "ent_id",
                                    "charid")
        self._ocr_name = str(cfg.opt.get("preprocess_ocr_name", "OCR")).split(",")[0]
        self._od_name = str(cfg.opt.get("preprocess_od_name", "OD")).split(",")[0]
        self._es_name = cfg.opt.get("ES_ocr")
        # the reference's `num_worker` key: featurize + item build across a
        # fork pool; 0 = serial (the default). Forked here, before this
        # engine puts its model on the card and before any of its threads
        # start: the fewer threads and the less device state at fork time,
        # the safer.
        self.num_workers = int(cfg.opt.get("num_worker", 0))
        self._pool = None
        if self.num_workers > 0:
            self._ensure_pool()
        # H2D slimming (`h2d_slim 1`): drop grid keys the model never reads
        # once the packed/unique tables are attached (collate.slim_block);
        # applied at the put AND to every warmup variant
        self._h2d_slim = bool(int(cfg.opt.get("h2d_slim", 1)))
        self._load_model(spec, params)

    def _load_model(self, spec: ModelSpec, params: Mapping[str, Any]):
        """Build the model and its eval step (the graphs of an earlier
        model go with it)."""
        with self.device:
            model = RUArtModel(spec)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
        if spec.use_bert:
            model.Bert.cache_compute_weights()
        self.model = model.eval()
        self.eval_step = make_eval_step(self.model, graphs=self.graphs)

    @property
    def graph_count(self) -> int:
        """The CUDA graphs captured so far (0 when the engine is eager)."""
        return len(self.eval_step) if isinstance(
            self.eval_step, SignatureGraphs) else 0

    def _slim(self, block):
        return slim_block(block) if self._h2d_slim else block

    def _renarrow(self, block):
        """Match warmup-variant dtypes to live traffic: hand-built variant
        keys (int32 zeros/aranges) must narrow exactly like the collator's
        output, or the warmed signatures would differ from the live ones.
        Idempotent; mutates ``block`` in place."""
        coll = self.collator
        if coll.narrow:
            narrow_block(block, coll.narrow_word16, coll.narrow_bert16)
        return block

    # -- host featurization ------------------------------------------------
    def _to_raw_datum(self, sample: Dict[str, Any], qid: int) -> Dict[str, Any]:
        datum = {
            "question": sample["question"],
            "question_id": qid,
            "file_path": sample.get("image_path", ""),
            "image_width": sample.get("image_width", 1),
            "image_height": sample.get("image_height", 1),
            self._ocr_name: [
                {"word": t["word"], "pos": t.get("pos", _ZERO8)}
                for t in sample.get("ocr", [])
            ],
            self._od_name: [
                {"object": t["object"], "pos": t.get("pos", _ZERO4)}
                for t in sample.get("od", [])
            ],
        }
        if self._es_name:
            datum[self._es_name] = [
                {
                    "word": t["word"],
                    "pos": t.get("pos", _ZERO8),
                    "cnt": t.get("cnt", 1),
                    "idx": i,
                }
                for i, t in enumerate(sample.get("es", sample.get("ocr", [])))
            ]
        return datum

    def featurize(self, samples: Sequence[Dict[str, Any]],
                  base: int = 0) -> VQADataset:
        raw = [self._to_raw_datum(s, base + i) for i, s in enumerate(samples)]
        data = self._pre._process_data(raw)
        self._pre._assign_ids(data)
        return VQADataset(data, self.cfg, mode="test", tokenizer=self.tokenizer)

    def _build_items(self, chunk: Sequence[Dict[str, Any]], base: int = 0):
        """Featurize + build dataset items for ``chunk`` (qids start at
        ``base`` so worker slices keep globally-unique in-batch ids)."""
        ds = self.featurize(chunk, base)
        return [ds[i] for i in range(len(ds))]

    # -- the num_worker pool -------------------------------------------------
    def _ensure_pool(self):
        """Fork the serving worker pool (once). Workers inherit the engine
        (preprocessor, vocab, tokenizer) by copy-on-write and do only
        python/numpy work — featurization is per-sample independent and
        deterministic, so pooled items are exactly the serial ones."""
        if self._pool is not None:
            return self._pool
        if "fork" not in multiprocessing.get_all_start_methods():
            self.num_workers = 0  # no fork (e.g. windows): stay serial
            return None
        global _FORK_ENGINE
        # bound for the POOL'S LIFETIME, not just the first fork: the pool
        # re-forks a replacement whenever a worker dies. Restored in
        # close(); one pooled engine per process, as a consequence.
        _FORK_ENGINE = self
        self._pool = multiprocessing.get_context("fork").Pool(
            processes=self.num_workers
        )
        return self._pool

    def close(self):
        global _FORK_ENGINE
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
            if _FORK_ENGINE is self:
                _FORK_ENGINE = None

    # the pool holds real worker processes: deterministic release with a
    # with-block, plus a best-effort safety net on collection
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- inference -----------------------------------------------------------
    def _collated_batches(self, samples: Sequence[Dict[str, Any]]):
        """Featurize -> dataset items -> collate, one batch at a time.
        Yields (first_sample_idx, n_real, batch). The tail batch is padded
        by repeating its last item: the whole-tensor layer norm spans the
        batch, so a tail run at its true size would change every score."""
        B = self.batch_size
        pool = self._ensure_pool() if self.num_workers > 0 else None
        for start in range(0, len(samples), B):
            chunk = list(samples[start: start + B])
            if pool is not None and len(chunk) > 1:
                n = min(self.num_workers, len(chunk))
                step = -(-len(chunk) // n)
                jobs = [
                    (off, chunk[off: off + step])
                    for off in range(0, len(chunk), step)
                ]
                items = [
                    item for part in pool.map(_fork_serve_items, jobs)
                    for item in part
                ]
            else:
                items = self._build_items(chunk)
            while len(items) < B:
                items.append(items[-1])
            yield start, len(chunk), self.collator(items)

    def _host(self, block: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Slim and check one collated block; CPU tensors, pinned when
        bound for a card (``data.pipeline.host_block``)."""
        return host_block(block, self.spec, self._h2d_slim,
                          pin=self.device.type == "cuda")

    def to_device(self, block: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Slim, check and move one collated host block to the device;
        aliased grids (one array under several keys) move once."""
        return put_block(self._host(block), self.device)

    def _forward(self, blocks) -> torch.Tensor:
        """The scores of one batch on the device: a replay of its
        signature's graph (captured now if it is new), or the eager model.
        A replay's scores are overwritten by the next replay of the same
        signature: :meth:`_launch` enqueues their copy to the host at
        once."""
        return self.eval_step(*blocks, None)[0]

    def _launch(self, blocks):
        """Enqueue the forward and the copy of its scores to the host right
        behind it; returns the fetch (``data.pipeline.fetch_async``), which
        waits for this batch alone, not for batches enqueued after it."""
        return fetch_async(self._forward(blocks))

    def _decode(self, scores: torch.Tensor, num: np.ndarray, extra,
                n_real: int) -> List[Dict[str, Any]]:
        _, save_res, _, _ = decode_batch(
            scores.cpu().numpy(), extra, num, self.fixed_answers,
            yesno=self.spec.label_yesno,
            label_no_answer=self.spec.label_no_answer,
        )
        return [
            {
                "answer": save_res[j]["prediction"],
                "score": save_res[j]["score"],
                "idx": save_res[j]["idx"],
            }
            for j in range(n_real)
        ]

    def predict(self, samples: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Returns [{'answer', 'score', 'idx'}] aligned with samples.

        A prefetch thread featurizes, collates and pins batch N+1 while
        the device runs batch N; batch N is fetched and decoded only after
        batch N+1 is dispatched, so the device does not idle through the
        fetch and the decode (the evaluator's one-batch-behind drain; the
        fetch waits for batch N alone)."""
        results: List[Dict[str, Any]] = [None] * len(samples)

        def host_put(batch):
            start, n_real, (q, ocr, od, _gt, extra) = batch
            blocks = [self._host(b) for b in (q, ocr, od)]
            return start, n_real, blocks, ocr["num"], extra

        def drain(pending):
            start, n_real, fetch, num, extra = pending
            results[start: start + n_real] = self._decode(fetch()[0], num,
                                                          extra, n_real)

        pending = None
        for start, n_real, blocks, num, extra in prefetch(
            self._collated_batches(samples), size=2, host_put=host_put
        ):
            # non-blocking copies on this thread's stream, then the forward
            # on the same stream: ordered without an event
            fetch = self._launch([put_block(b, self.device) for b in blocks])
            if pending is not None:
                drain(pending)
            pending = (start, n_real, fetch, num, extra)
        if pending is not None:
            drain(pending)
        return results

    # -- staged single-wave API (BatchingServer's two-stage pipeline) -----
    def _stream(self):
        """The device's default stream. ``prepare`` and ``dispatch`` run on
        different threads; both enqueue on this one stream, so each wave's
        non-blocking H2D copies are ordered before the forward that reads
        them (dispatch enqueues it after prepare has returned)."""
        if self.device.type == "cuda":
            return torch.cuda.stream(torch.cuda.default_stream(self.device))
        return contextlib.nullcontext()

    def prepare(self, samples: Sequence[Dict[str, Any]]):
        """Host stage for one wave (<= batch_size samples): featurize ->
        item build -> collate -> H2D. Returns an opaque prepared wave."""
        _, n_real, (q, ocr, od, _gt, extra) = next(
            self._collated_batches(samples)
        )
        with self._stream():
            blocks = [self.to_device(b) for b in (q, ocr, od)]
        return n_real, blocks, ocr["num"], extra

    def dispatch(self, prepared):
        """Device stage: enqueue the forward (asynchronous — device errors
        surface at the fetch inside :meth:`decode_pending`). Returns a
        pending handle."""
        n_real, blocks, num, extra = prepared
        with self._stream():
            fetch = self._launch(blocks)
        return fetch, num, extra, n_real

    def decode_pending(self, pending) -> List[Dict[str, Any]]:
        """Drain stage: fetch the scores and decode the wave's real rows."""
        fetch, num, extra, n_real = pending
        return self._decode(fetch()[0], num, extra, n_real)

    # -- production knobs -------------------------------------------------
    def quantize(self) -> "InferenceEngine":
        """Switch to the weight-only-int8 encoder (the INT8_BERT serving
        mode): quantizes the current weights and rebuilds the model under
        the int8 spec on the engine's device. Idempotent; returns self."""
        if self.spec.bert is None or self.spec.bert.quant == "int8":
            return self
        params = quantize_bert_params(self.model.state_dict())
        self.spec = dataclasses.replace(
            self.spec, bert=dataclasses.replace(self.spec.bert, quant="int8")
        )
        self._load_model(self.spec, params)
        return self

    def _warm_step(self, q, ocr, od):
        """Run the eval step once on one batch signature. JAX compiles one
        XLA program per signature here; on a card the port captures the
        signature's CUDA graph (after one eager run that builds the
        attention kernel and pays cuDNN's and the allocator's first use of
        each shape), eagerly it runs the model once."""
        self._forward([self.to_device(b) for b in (q, ocr, od)])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, max_programs: Optional[int] = None) -> int:
        """Run every batch signature the collator can emit once — the
        (OCR num/len bucket) x (q-BERT width) x (OCR/OD word width) x
        (OCR dedup (rows, len[, packed rows]) or dense) x (OD dedup or
        dense) x (OCR/OD cand_sel length or dense grid) product, the same
        signatures in the same order as the JAX package's warmup compiles.
        ``max_programs`` truncates it (logged). PREFER
        :meth:`warmup_calibrated` with a sample of real traffic. Returns
        the number of signatures run."""
        coll, cfg = self.collator, self.cfg
        count = 0
        B = self.batch_size

        def dedup_opts(max_num: int, bert_len: int):
            if coll.pack:
                # packed mode: (rows, lsz, packed-row) triples
                return (None,) + tuple(
                    (rows, lsz, R)
                    for rows in coll.dedup_sizes(B, max_num)
                    for lsz in coll.dedup_len_ladder(bert_len)
                    for R in coll.pack_row_ladder(rows)
                )
            return (None,) + tuple(
                (rows, lsz)
                for rows in coll.dedup_sizes(B, max_num)
                for lsz in coll.dedup_len_ladder(bert_len)
            )

        # candidate-compaction axis: None (dense grid) plus the cand_sel
        # ladder lengths REACHABLE in this num bucket — every sample
        # contributes >= 1 real row and at least one sample's count exceeds
        # the previous num bucket, so real rows >= B + prev_bucket
        def plausible_sels(nb: int, buckets) -> tuple:
            prev = max((x for x in buckets if x < nb), default=0)
            r_min = B + prev
            return (None,) + tuple(
                s for s in coll.compact_sizes(B, nb) if s >= r_min
            )

        shape_axes = list(itertools.product(
            coll.ocr_num_buckets, coll.ocr_len_buckets, coll.q_bert_buckets,
            coll.ocr_word_buckets, coll.od_word_buckets,
        ))
        for n_bucket, l_bucket, q_len, ocr_w, od_w in shape_axes:
            q, ocr, od, _ = make_synthetic_batch(
                self.spec, cfg, B, seed=0,
                ocr_num=n_bucket, ocr_bert_len=l_bucket, q_bert_len=q_len,
                ocr_word_len=ocr_w, od_word_len=od_w,
            )
            # q_pack: live q blocks ALWAYS carry the packed table (frac 1.0
            # never falls back), so warm the as-collated signature
            if coll.q_pack and coll.pack and coll.dedup_frac > 0:
                coll._add_dedup(q, B, 1, q["bert"].shape[-1], frac=1.0)
                if "bert_inverse" in q:
                    q["bert_inverse"] = q["bert_inverse"].reshape(B)
            ocr_opts = dedup_opts(n_bucket, l_bucket)
            od_opts = dedup_opts(od["bert"].shape[1], od["bert"].shape[2])
            ocr_sels = plausible_sels(n_bucket, coll.ocr_num_buckets)
            od_n = od["bert"].shape[1]
            od_sels = plausible_sels(od_n, (od_n,))
            for opt_ocr, opt_od, sel_ocr, sel_od in itertools.product(
                ocr_opts, od_opts, ocr_sels, od_sels
            ):
                if max_programs is not None and count >= max_programs:
                    log.warning(
                        "warmup stopped at max_programs=%d; the remaining "
                        "signatures pay their first use live", max_programs,
                    )
                    self._sync()
                    return count
                ocr_v, od_v = dict(ocr), dict(od)
                for block, opt_rl, n_sel in (
                    (ocr_v, opt_ocr, sel_ocr), (od_v, opt_od, sel_od)
                ):
                    for k in DEDUP_KEYS + COMPACT_KEYS:
                        block.pop(k, None)
                    if n_sel is not None:
                        # only the length matters to the signature; real
                        # in-range indices keep the scatter well-formed
                        Bb, N = block["num"].shape[0], block["bert"].shape[1]
                        block["cand_sel"] = (
                            np.arange(n_sel, dtype=np.int32) % (Bb * N)
                        )
                    if opt_rl is None:
                        continue
                    size, lsz = opt_rl[:2]
                    Bb, N, Lb = block["bert"].shape
                    block["bert_inverse"] = np.zeros((Bb, N), np.int32)
                    # real batches always carry the per-unique word spans
                    # alongside the table (zeros: only shapes matter)
                    W = block["bert_offsets"].shape[2]
                    block["bert_unique_offsets"] = np.zeros(
                        (size, W, 2), np.int32
                    )
                    if len(opt_rl) == 3:
                        # packed signature: one max-width segment per row
                        R = opt_rl[2]
                        Lp = max(coll.pack_len, lsz)
                        seg = np.zeros((R, Lp), np.int32)
                        pos = np.zeros((R, Lp), np.int32)
                        seg[:, :lsz] = 1
                        pos[:, :lsz] = np.arange(lsz)
                        block["bert_packed"] = seg.copy()  # token id 1
                        block["bert_packed_seg"] = seg
                        block["bert_packed_pos"] = pos
                        block["bert_unpack"] = np.zeros((size, lsz), np.int32)
                        continue
                    uniq = block["bert"].reshape(Bb * N, Lb)[:size, :lsz]
                    if uniq.shape[0] < size:
                        uniq = np.concatenate([
                            uniq,
                            np.zeros((size - uniq.shape[0], lsz), np.int32),
                        ])
                    block["bert_unique"] = uniq.astype(np.int32)
                self._warm_step(
                    self._slim(self._renarrow(q)),
                    self._slim(self._renarrow(ocr_v)),
                    self._slim(self._renarrow(od_v)),
                )
                count += 1
        self._sync()
        return count

    def _q_top_tables(self, q: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The q block rebuilt with its packed tables at the TOP ladder
        buckets (size = cap, lsz = widest, R = row-ladder top) — the
        worst-case q_pack signature a live batch can produce. Only shapes
        matter. None when q packing is off."""
        coll = self.collator
        if not (coll.q_pack and coll.pack and coll.dedup_frac > 0):
            return None
        B, Lqb = q["bert"].shape
        size = coll.dedup_cap(B, 1, 1.0)
        lsz = coll.dedup_len_ladder(Lqb)[-1]
        R = coll.pack_row_ladder(size)[-1]
        Lp = max(coll.pack_len, lsz)
        out = {k: v for k, v in q.items() if k not in DEDUP_KEYS}
        seg = np.zeros((R, Lp), np.int32)
        pos = np.zeros((R, Lp), np.int32)
        seg[:, :lsz] = 1
        pos[:, :lsz] = np.arange(lsz)
        out["bert_packed"] = seg.copy()  # token id 1 where seg == 1
        out["bert_packed_seg"] = seg
        out["bert_packed_pos"] = pos
        out["bert_unpack"] = np.zeros((size, lsz), np.int32)
        W = q["bert_offsets"].shape[1]
        out["bert_unique_offsets"] = np.zeros((size, W, 2), np.int32)
        out["bert_inverse"] = np.zeros((B,), np.int32)
        return out

    def warmup_calibrated(self, samples: Sequence[Dict[str, Any]]) -> int:
        """Run exactly the signatures a calibration sample of real traffic
        produces, plus every fallback a live batch can land on: the
        dedup-stripped, compaction-stripped and both-stripped variants of
        each observed signature, the next-larger cand_sel bucket, the
        top-bucket q tables, and the all-caps dense "panic" signature.
        The RECOMMENDED warmup mode. Returns the number of signatures
        run."""
        seen = set()
        count = 0

        def run(qq, oo, dd):
            nonlocal count
            # variants are built on FULL host dicts; narrow + slim exactly
            # like the live collate/put path so the signature (dtypes
            # included) matches
            qq, oo, dd = (
                self._slim(self._renarrow(dict(t))) for t in (qq, oo, dd)
            )
            sig = tuple(
                (k, v.shape)
                for t in (qq, oo, dd)
                for k, v in sorted(t.items())
            )
            if sig in seen:
                return
            seen.add(sig)
            self._warm_step(qq, oo, dd)
            count += 1

        def strip(block, keys):
            return {k: v for k, v in block.items() if k not in keys}

        def bump_sel(block):
            """The block with cand_sel padded to the next-larger ladder
            bucket (None when absent or already at the top)."""
            if "cand_sel" not in block:
                return None
            B, N = block["bert"].shape[:2]
            bigger = [
                s for s in self.collator.compact_sizes(B, N)
                if s > block["cand_sel"].shape[0]
            ]
            if not bigger:
                return None
            out = dict(block)
            sel = np.full(bigger[0], B * N, np.int32)
            sel[: block["cand_sel"].shape[0]] = np.asarray(block["cand_sel"])
            out["cand_sel"] = sel
            return out

        for _, _, (q, ocr, od, _gt, _extra) in self._collated_batches(samples):
            for ks in ((), DEDUP_KEYS, COMPACT_KEYS, DEDUP_KEYS + COMPACT_KEYS):
                oo, dd = strip(ocr, ks), strip(od, ks)
                run(q, oo, dd)
                bo, bd = bump_sel(oo), bump_sel(dd)
                if bo is not None or bd is not None:
                    run(q, bo if bo is not None else oo,
                        bd if bd is not None else dd)
            # q_pack bucket drift: warm the worst-case (top-bucket) q
            # signature against this batch's typical ocr/od blocks
            qt = self._q_top_tables(q)
            if qt is not None:
                run(qt, ocr, od)
        # the panic signature: conf caps, dense candidate grid, no
        # dedup/compaction; q keeps its top-bucket packed tables when
        # q_pack is on (live q blocks always carry the table)
        q, ocr, od, _ = make_synthetic_batch(
            self.spec, self.cfg, self.batch_size, seed=0
        )
        for block in (ocr, od):
            for k in DEDUP_KEYS + COMPACT_KEYS:
                block.pop(k, None)
        run(self._q_top_tables(q) or q, ocr, od)
        self._sync()
        return count

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_trainer(cls, trainer) -> "InferenceEngine":
        """An engine on the trainer's device with the trainer's current
        weights (``ruart_tpu_torch.train.trainer.Trainer``)."""
        return cls(
            trainer.cfg, trainer.spec, trainer.model.state_dict(),
            getattr(trainer, "vocab", trainer.preproc.train_vocab or []),
            trainer.tokenizer, trainer.fixed_answers, device=trainer.device,
        )


class BatchingServer:
    """Dynamic micro-batching front end over :class:`InferenceEngine`.

    Online callers submit ONE request at a time; the device wants full
    fixed-shape batches. A gather thread drains the request queue into
    waves of up to ``engine.batch_size``, dispatching early after
    ``max_wait_ms`` so a lone request is never stuck waiting for
    neighbours, and runs each wave's host stage (``engine.prepare``: the
    wave is padded to the full batch by repeating its last request); a
    device thread dispatches the forward and decodes.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to the
    engine's ``{'answer', 'score', 'idx'}`` dict; ``predict_one`` is the
    blocking convenience wrapper. Thread-safe; call ``close()`` (or use as
    a context manager) to drain and stop the threads.
    """

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 10.0):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._lat_lock = threading.Lock()
        self._latencies_s: List[float] = []
        self._batch_sizes: List[int] = []
        # two stages: under continuous traffic wave K+1's host work
        # overlaps wave K's device work (throughput ~= the slower stage);
        # the bounded queue caps in-flight host work (backpressure)
        self._prep_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._gather = threading.Thread(target=self._gather_loop, daemon=True)
        self._device = threading.Thread(target=self._device_loop, daemon=True)
        self._gather.start()
        self._device.start()

    # -- client side -----------------------------------------------------
    def submit(self, sample: Dict[str, Any]) -> Future:
        if self._stop.is_set():
            raise RuntimeError("BatchingServer is closed")
        fut: Future = Future()
        self._q.put((sample, fut, time.monotonic()))
        return fut

    def predict_one(self, sample: Dict[str, Any], timeout: Optional[float] = None):
        return self.submit(sample).result(timeout)

    # -- workers ----------------------------------------------------------
    def _gather_loop(self):
        """Form waves from the request queue and run the HOST stage."""
        B = self.engine.batch_size
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    self._prep_q.put(None)  # sentinel: no more waves
                    return
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < B:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                prepared = self.engine.prepare([s for s, _, _ in batch])
            except Exception as e:  # delivered to the wave's futures
                self._fail(batch, e)
                continue
            self._prep_q.put((prepared, batch))

    def _device_loop(self):
        """Dispatch prepared waves; under back-to-back traffic wave K is
        drained only after wave K+1 is dispatched (the device never idles
        through the fetch), but an idle queue drains at once so a lone
        request is never held hostage to traffic that may not come."""
        pending = None
        while True:
            if pending is not None:
                try:
                    item = self._prep_q.get_nowait()
                except queue.Empty:
                    self._drain(*pending)
                    pending = None
                    continue
            else:
                item = self._prep_q.get()
            if item is None:
                if pending is not None:
                    self._drain(*pending)
                return
            prepared, batch = item
            try:
                handle = self.engine.dispatch(prepared)
            except Exception as e:  # delivered to the wave's futures
                self._fail(batch, e)
                handle = None
            if pending is not None:
                self._drain(*pending)
            pending = (handle, batch) if handle is not None else None

    def _drain(self, handle, batch):
        try:
            results = self.engine.decode_pending(handle)
        except Exception as e:  # delivered to the wave's futures
            self._fail(batch, e)
            return
        done = time.monotonic()
        with self._lat_lock:
            self._batch_sizes.append(len(batch))
            self._latencies_s.extend(done - t0 for _, _, t0 in batch)
        for (_, fut, _), res in zip(batch, results):
            if not fut.cancelled():
                fut.set_result(res)

    @staticmethod
    def _fail(batch, exc):
        for _, fut, _ in batch:
            if not fut.cancelled():
                fut.set_exception(exc)

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Request-latency percentiles (submit -> result) and batch-fill
        stats since startup. Empty dict before any batch."""
        with self._lat_lock:
            lats = np.asarray(self._latencies_s, dtype=np.float64)
            fills = np.asarray(self._batch_sizes, dtype=np.float64)
        if lats.size == 0:
            return {}
        return {
            "requests": int(lats.size),
            "batches": int(fills.size),
            "latency_p50_ms": float(np.percentile(lats, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(lats, 99) * 1e3),
            "latency_max_ms": float(lats.max() * 1e3),
            "mean_batch_fill": float(fills.mean() / self.engine.batch_size),
        }

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float = 30.0):
        """Stop accepting work, drain in-flight requests, join the
        threads."""
        self._stop.set()
        self._gather.join(timeout)
        self._device.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
