"""Fixed-shape batch assembly.

Packs ragged per-item features into the [B, N, L] tensors the model
consumes (schema in `ruart_tpu_torch.models.fusion.model`). Semantics follow the
reference collate (`Utils/VQA_Dataset.py:439-517`): zero padding, masks are
id != 0, `num`/`len` carry candidate/word counts. Unlike the reference
(which crashes on over-long items), inputs are truncated to the conf caps.

Copy of ``ruart_tpu/data/collate.py``. The ragged->fixed fill loops run
in the native ``fastcollate`` extension (``native/fastcollate.cc``, built
with g++ at the first collate), ~10-50x less interpreter dispatch than
the numpy walks, which stay as the fallback and as the oracle the tests
hold the extension to. ``RUART_NO_NATIVE=1`` opts out; a failed build
logs the compiler's error and keeps the numpy path
(:func:`native_active` says which runs).
"""

from __future__ import annotations

import functools
import logging
import os
from itertools import chain
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ruart_tpu_torch.core.config import Config

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=1)
def _fc():
    """The fastcollate extension, built and loaded at the first call, or
    None (opted out, or the build or load failed)."""
    if os.environ.get("RUART_NO_NATIVE"):
        return None
    from ruart_tpu_torch.native.build import load_fastcollate

    try:
        return load_fastcollate()
    except (RuntimeError, ImportError, OSError) as e:
        log.warning("native fastcollate unavailable, collating with numpy: %s", e)
        return None


def native_active() -> bool:
    """Whether the collator runs the native fill loops."""
    return _fc() is not None

# every batch key the dedup/packing paths can attach to a candidate block
# (serve-time dense fallbacks strip exactly this set)
DEDUP_KEYS = (
    "bert_unique", "bert_inverse", "bert_unique_offsets",
    "bert_packed", "bert_packed_seg", "bert_packed_pos", "bert_unpack",
)

# candidate-row compaction key (`cand_compact 1`, see _add_compact):
# independent of the dedup/pack keys — a block can carry any combination
COMPACT_KEYS = ("cand_sel",)


def slim_block(block):
    """Drop grid keys whose VALUES the model provably never reads once the
    dedup/packed encoder tables are attached (`h2d_slim 1`, default on):

    * ``bert`` [B, N, Lb] and ``bert_mask`` — the encoder consumes
      ``bert_unique``/``bert_packed*`` instead (model._bert_words); only
      key MEMBERSHIP is checked, which `_fused_bert` resolves against the
      table keys too.
    * ``bert_offsets`` [B, N, W, 2] — pool-before-expand pools word spans
      on the unique table via ``bert_unique_offsets``.

    These are ~half a flagship batch's H2D bytes, for buffers the model
    never reads. Returns a shallow copy (or ``block`` unchanged when nothing applies) —
    the HOST batch keeps every key so warmup/fallback logic can rebuild
    dense signatures."""
    if not ("bert_packed" in block or "bert_unique" in block) or \
            "bert_inverse" not in block:
        return block
    dead = ["bert", "bert_mask"]
    if "bert_unique_offsets" in block:
        dead.append("bert_offsets")
    if not any(k in block for k in dead):
        return block
    return {k: v for k, v in block.items() if k not in dead}


# --- H2D dtype narrowing (`h2d_narrow 1`, default on) ---------------------
# The flagship batch ships ~9 MB of int32 grids whose VALUES all fit in
# 8/16 bits (word ids < vocab, POS/ENT tag ids < 128, wordpiece ids
# < 30522, offsets/positions < 512, gather indices < their static table
# sizes). The H2D transfer is PCIe traffic, so the collator emits the
# narrowest safe dtype and the model widens the grids on device. EXACT by
# construction: every gate below is a static bound (conf caps, frozen tag
# tables, array shapes — all of which are already compile keys), never the
# batch's data, so dtypes are stable per program signature.

# keys whose values are bounded by the frozen spaCy tag tables
_NARROW_INT8 = ("pos", "ent")
# keys bounded by a sequence-length cap (<= 512 everywhere)
_NARROW_INT16 = (
    "len", "num", "bert_packed_seg", "bert_packed_pos",
    "bert_offsets", "bert_unique_offsets",
)
# wordpiece-id keys (bounded by the BERT vocab)
_BERT_ID_KEYS = ("bert", "bert_unique", "bert_packed")
# word-id keys (bounded by the task vocab; aliased grids stay aliased)
_WORD_ID_KEYS = ("glove", "fasttext", "phoc")


def narrow_block(block, word16: bool, bert16: bool):
    """Narrow a collated block's integer arrays in place (returns block).

    ``word16``/``bert16`` say whether the word / wordpiece vocabularies fit
    int16 (conf-derived). Index keys (``bert_inverse``, ``bert_unpack``,
    ``cand_sel``) narrow only when their STATIC bound — the shape of the
    table they index — fits, which keeps the dtype a pure function of the
    program signature."""
    for k in _NARROW_INT8:
        if k in block and block[k].dtype != np.int8:
            block[k] = block[k].astype(np.int8)
    for k in _NARROW_INT16:
        if k in block and block[k].dtype.itemsize > 2:
            block[k] = block[k].astype(np.int16)
    if "bert_mask" in block and block["bert_mask"].dtype != np.int8:
        block["bert_mask"] = block["bert_mask"].astype(np.int8)
    if bert16:
        for k in _BERT_ID_KEYS:
            if k in block and block[k].dtype.itemsize > 2:
                block[k] = block[k].astype(np.int16)
    if word16:
        cast = []  # (src, narrowed) pairs — aliased grids stay aliased
        for k in _WORD_ID_KEYS:
            v = block.get(k)
            if v is not None and v.dtype.itemsize > 2:
                hit = next((c for v2, c in cast if v is v2), None)
                if hit is None:
                    hit = v.astype(np.int16)
                    cast.append((v, hit))
                block[k] = hit
    # gather indices: bound = the static size of what they index
    if "bert_inverse" in block and block["bert_inverse"].dtype.itemsize > 2:
        table = next(
            (block[k] for k in ("bert_unique", "bert_unique_offsets",
                                "bert_unpack") if k in block), None,
        )
        if table is not None and table.shape[0] < 2 ** 15:
            block["bert_inverse"] = block["bert_inverse"].astype(np.int16)
    if "bert_unpack" in block and block["bert_unpack"].dtype.itemsize > 2 \
            and "bert_packed" in block and block["bert_packed"].size < 2 ** 15:
        block["bert_unpack"] = block["bert_unpack"].astype(np.int16)
    if "cand_sel" in block and block["cand_sel"].dtype.itemsize > 2:
        ids = next((block[k] for k in _WORD_ID_KEYS if k in block), None)
        # sentinel value == B * max_num (inclusive bound)
        if ids is not None and ids.shape[0] * ids.shape[1] < 2 ** 15:
            block["cand_sel"] = block["cand_sel"].astype(np.int16)
    return block


def _parse_buckets(raw, cap: int, floor: int = 1) -> Tuple[int, ...]:
    """Bucket ladder for one shape dimension, largest = the conf cap.

    ``raw`` is the conf value: an int N generates N power-of-2 steps
    (cap, cap/2, ... , each >= floor); a comma list gives explicit sizes
    (the cap is appended if missing). Returns ascending sizes."""
    if raw in (None, "", 0, 1, False):
        return (cap,)
    if isinstance(raw, str):
        sizes = {int(t) for t in raw.split(",") if t.strip()}
    else:
        sizes, size = set(), cap
        for _ in range(int(raw)):
            sizes.add(size)
            size = max((size + 1) // 2, floor)
    sizes = {min(max(s, floor), cap) for s in sizes}
    sizes.add(cap)
    return tuple(sorted(sizes))


def _pick_bucket(buckets: Sequence[int], needed: int) -> int:
    for b in buckets:
        if b >= needed:
            return b
    return buckets[-1]


def _halving_ladder(cap: int, steps: int, align: int, floor: int) -> Tuple[int, ...]:
    """Ascending bucket ladder: ``cap`` plus up to ``steps - 1`` halvings,
    each rounded up to ``align`` and floored at ``floor``; candidates that
    save under 25% vs the last kept size are skipped (a compiled program
    that buys <25% is not worth its compile)."""
    out, size, last = [cap], cap, cap
    for _ in range(max(1, steps) - 1):
        size = max(floor, ((size // 2 + align - 1) // align) * align)
        if size < last * 3 // 4:
            out.append(size)
            last = size
        if size <= floor:
            break
    return tuple(sorted(set(out)))


def _pad_ids(rows: Sequence[Sequence[int]], max_len: int) -> np.ndarray:
    n = len(rows)
    fc = _fc()
    if fc is not None and isinstance(rows, list):
        out = np.zeros((n, max_len), dtype=np.int32)
        fc.pad_rows(rows, out, np.zeros(n, np.int64), max_len)
        return out
    rows = [r[:max_len] if len(r) > max_len else r for r in rows]
    lens = np.fromiter(map(len, rows), np.int64, n)
    vals = np.fromiter(chain.from_iterable(rows), np.int32, int(lens.sum()))
    out = np.zeros((n, max_len), dtype=np.int32)
    out[np.arange(max_len)[None, :] < lens[:, None]] = vals
    return out


def _pad_offsets(
    offset_rows: Sequence[Sequence[Tuple[int, int]]], max_words: int, max_bert: int
) -> np.ndarray:
    n = len(offset_rows)
    rows = [
        o[:max_words] if len(o) > max_words else o for o in offset_rows
    ]
    counts = np.fromiter(map(len, rows), np.int64, n)
    pairs = np.fromiter(
        chain.from_iterable(chain.from_iterable(rows)),
        np.int32,
        int(counts.sum()) * 2,
    ).reshape(-1, 2)
    st = np.minimum(pairs[:, 0], max_bert - 1)
    ed = np.maximum(np.minimum(pairs[:, 1], max_bert), st)
    out = np.zeros((n, max_words, 2), dtype=np.int32)
    mask = np.arange(max_words)[None, :] < counts[:, None]
    out[mask] = np.stack([st, ed], axis=1)
    return out


def unique_rows(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact unique rows + inverse in first-appearance order.

    Replaces ``np.unique(flat, axis=0, return_inverse=True)``, whose
    lexicographic argsort over [B*N, Lb] int rows was the single hottest
    collator op (~65 ms at flagship shapes vs ~8 ms here): hash each row's
    raw bytes in one dict pass — exact (byte equality, no hash-collision
    risk) and O(rows) instead of O(rows log rows)."""
    n = flat.shape[0]
    flat = np.ascontiguousarray(flat)
    fc = _fc()
    if fc is not None and n:
        inverse = np.empty(n, np.int64)
        firsts = np.empty(n, np.int64)
        k = fc.unique_rows(
            flat, n, flat.shape[1] * flat.itemsize, inverse, firsts
        )
        return flat[firsts[:k]], inverse
    table: Dict[bytes, int] = {}
    inverse = np.empty(n, np.int64)
    first_rows = []
    row_bytes = flat.tobytes()
    stride = flat.shape[1] * flat.itemsize
    get = table.get
    for i in range(n):
        key = row_bytes[i * stride: (i + 1) * stride]
        j = get(key)
        if j is None:
            j = len(table)
            table[key] = j
            first_rows.append(i)
        inverse[i] = j
    return flat[first_rows], inverse


class Collator:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.num_scores = cfg.dims.num_scores
        # BERT candidate dedup (ON by default): real batches repeat
        # candidate strings heavily (the <OCR> sentinel appears once per
        # question; ES and n-gram sources overlap; scene text repeats), and
        # the encoder output depends only on the piece-id row — encode
        # unique rows, gather back on device. bert_dedup_frac caps the
        # unique table at frac * B * N rows (rounded up to 64); batches
        # with more uniques fall back to the dense path (logged). The 0.25
        # default is 2.5-4x above rates measured through the real pipeline
        # on realistic synthetic data (OCR ~6-10% unique, OD ~0.5-2%;
        # PROGRESS_NOTES.md round 2). Set bert_dedup_frac 0 to disable.
        self.dedup_frac = float(cfg.opt.get("bert_dedup_frac", 0.25))
        # unique-table cap buckets (power-of-2 ladder below the cap):
        # 1 = single fixed cap shape; default 4 because batch-global
        # duplication grows SUBLINEARLY with batch (the unique-string pool
        # is the scene-text vocabulary, not the batch): at batch 256 the
        # realistic pipeline yields ~650 unique OCR rows against a 6400-row
        # cap, so a 2-step ladder bottoming at 3200 encodes ~80% pad. Each
        # extra step costs one jit program (bounded, warmup-precompiled).
        self.dedup_buckets = int(cfg.opt.get("bert_dedup_buckets", 4))
        # unique-table *sequence* buckets: candidate strings are short
        # (realistic n-gram candidates max out ~14 pieces vs the 30 cap),
        # and the encoder output per row is independent of trailing pad
        # (masked attention keys, per-position layer norm) — so the unique
        # table also pads its wordpiece axis to the smallest 8-aligned
        # halving bucket that fits the batch's longest row. Exact by
        # construction; the dense [B, N, Lb] block keeps the conf cap so
        # fusion-stack shapes (and scores) are untouched.
        self.dedup_len_buckets = int(cfg.opt.get("bert_dedup_len_buckets", 2))
        # sequence packing of the unique table (`bert_pack 1`): candidate
        # strings average far fewer wordpieces than the padded width, so
        # several candidates share one encoder row, separated by a
        # block-diagonal segment mask with per-segment position restart.
        # EXACT by construction (cross-segment keys get the same -10000
        # additive bias as pad keys, which underflows to a hard zero in the
        # fp32 softmax — identical math to the dense row, see
        # models/bert/model.py). Cuts encoder rows ~2-4x on realistic
        # batches; the encoder is the device-profile majority. ON by
        # default; `bert_pack 0` opts out. Packing rides the dedup table,
        # so bert_dedup_frac 0 also disables it.
        self.pack = bool(int(cfg.opt.get("bert_pack", 1)))
        self.pack_len = int(cfg.opt.get("bert_pack_len", 32))
        # question-row packing (`q_pack 1`): the [B, Lqb] question grid is
        # mostly pad too (real questions average ~12 pieces against the
        # 50-piece cap) and the q encoder call was ~26 ms of the 115 ms
        # flagship batch (round-4 DCE profile). The q block rides the SAME
        # dedup+pack machinery with max_num=1 and frac=1.0 (the table
        # always attaches — questions rarely duplicate, the win is the
        # packing); bert_inverse collapses to [B]. Exact for the same
        # reason candidate packing is. Rides bert_pack: q_pack 0 (or
        # bert_pack 0) opts out.
        self.q_pack = bool(int(cfg.opt.get("q_pack", 1)))
        # packing cuts rows 2-4x on realistic candidate lengths, so the
        # packed-row ladder must reach well below size/2 (4 halving steps)
        self.pack_buckets = int(cfg.opt.get("bert_pack_buckets", 4))
        self.dedup_fallbacks = 0
        # length-bucketed compilation (SURVEY §3.5 #5): per-batch shapes pad
        # to the smallest bucket that fits instead of always the conf cap,
        # so short batches skip most of the padded-candidate BERT work. The
        # bucket ladders are FIXED per config -> the jit program count is
        # bounded by len(num_buckets) * len(len_buckets) (no recompile
        # storms). Off by default (single bucket = the reference's fixed
        # caps); enable with `bucket_ocr_num 3` / explicit `25,50,100`
        # lists, and `bucket_ocr_bert_len` for the wordpiece axis.
        es_floor = (
            int(cfg.opt.get("ES_ocr_len", 0)) + 2 if "useES" in cfg.opt else 1
        )
        self.ocr_num_buckets = _parse_buckets(
            cfg.opt.get("bucket_ocr_num"), cfg.max_ocr_num, floor=es_floor
        )
        self.ocr_len_buckets = _parse_buckets(
            cfg.opt.get("bucket_ocr_bert_len"), cfg.max_ocr_bert_len, floor=4
        )
        # EXACT per-batch buckets (on by default — unlike the opt-in
        # bucket_ocr_num/bucket_ocr_bert_len above, these cannot move any
        # score):
        # * question-BERT width: the q word axis (which feeds the
        #   pad-sensitive BiLSTMs) keeps its cap; only the wordpiece axis
        #   shrinks, and BERT output per row ignores trailing pad. Real
        #   questions run ~28 pieces against the 50 cap.
        # * candidate word axis (OCR/OD): realistic candidates are 1-5
        #   words against the 20-word cap, and the whole word-level
        #   pipeline is pad-exact — per-position embeds, mask-attended
        #   pre-align, and the FORWARD-only multi2one scan's last-valid
        #   state. A bidirectional multi2one (multi2one_bidir) runs its
        #   backward pass THROUGH trailing pads (reference-inherent pad
        #   sensitivity, `Layers.py:156-180`), so the trim is gated off.
        self.q_bert_buckets = _halving_ladder(
            cfg.max_q_bert_len, int(cfg.opt.get("bucket_q_bert_len", 2)),
            align=8, floor=8,
        )
        word_steps = int(cfg.opt.get("bucket_word_len", 3))
        if bool(cfg.opt.get("multi2one_bidir", False)):
            word_steps = 1
        self.ocr_word_buckets = _halving_ladder(
            cfg.max_ocr_len, word_steps, align=4, floor=4
        )
        self.od_word_buckets = _halving_ladder(
            cfg.max_od_len, word_steps, align=4, floor=4
        )
        # candidate-row compaction (`cand_compact 1`, ON by default): the
        # per-candidate pipeline (token embed + pre-align concat + the
        # multi2one scan + BERT unpack/pooling) is row-independent, and
        # realistic batches fill only a fraction of the [B, N] candidate
        # grid (num varies per question while N is the bucket/cap). The
        # collator attaches `cand_sel` — the flat indices of REAL candidate
        # rows, padded with the out-of-bounds sentinel B*N to a bucketed
        # length — and the model runs that whole stage on [R_cap] gathered
        # rows, scattering last-states back (pad indices drop, and the
        # candidate mask already zeroes pad rows). EXACT: candidate rows
        # never interact before the [B, N]-level context_rnn, which runs on
        # the scattered full grid.
        self.compact = bool(int(cfg.opt.get("cand_compact", 1)))
        self.compact_buckets = int(cfg.opt.get("cand_compact_buckets", 6))
        # H2D dtype narrowing (`h2d_narrow 1`, default on; see narrow_block)
        self.narrow = bool(int(cfg.opt.get("h2d_narrow", 1)))
        vocab_size = int(cfg.opt.get("vocab_size", 0))
        self.narrow_word16 = 0 < vocab_size < 2 ** 15
        # standard uncased BERT vocab is 30522; override `bert_vocab_size`
        # for custom vocabularies past 32767
        self.narrow_bert16 = int(cfg.opt.get("bert_vocab_size", 30522)) < 2 ** 15

    # -- candidate block -------------------------------------------------
    def _collate_items(
        self,
        batch_items: Sequence[Sequence[dict]],
        max_num: int,
        word_buckets: Sequence[int],
        max_bert_len: int,
    ) -> Dict[str, np.ndarray]:
        """Vectorized ragged->fixed packing: one flattened candidate list,
        then per key a single fromiter pass + one boolean-mask scatter —
        instead of a per-(sample, candidate, key) Python assignment loop,
        which dominated the host profile at flagship shapes (~0.11 s of a
        0.27 s batch-256 collate)."""
        B = len(batch_items)
        keys = batch_items[0][0].keys() if batch_items and batch_items[0] else []
        id_keys = [
            k for k in keys if k in ("glove", "fasttext", "phoc", "pos", "ent")
        ]
        has_bert = "bert" in keys
        len_key = "fasttext" if "FastText" in self.cfg.opt else "glove"

        # exact word-axis bucket: pad to the smallest ladder width that
        # holds the batch's longest (cap-truncated) candidate
        max_len = word_buckets[-1]
        if len(word_buckets) > 1:
            need_w = 1
            for items in batch_items:
                for it in items:
                    n = len(it[len_key])
                    if n > need_w:
                        need_w = n
            max_len = _pick_bucket(word_buckets, need_w)

        items_flat = []
        num = np.zeros((B,), dtype=np.int32)
        row_idx_parts = []
        for b, items in enumerate(batch_items):
            if len(items) > max_num:
                items = list(items)[:max_num]
            num[b] = len(items)
            items_flat.extend(items)
            row_idx_parts.append(
                np.arange(b * max_num, b * max_num + len(items), dtype=np.int64)
            )
        row_idx = (
            np.concatenate(row_idx_parts)
            if row_idx_parts
            else np.zeros(0, np.int64)
        )
        R = len(items_flat)

        out: Dict[str, np.ndarray] = {"num": num}

        def scatter(compact: np.ndarray, *trail: int) -> np.ndarray:
            full = np.zeros((B * max_num,) + trail, dtype=compact.dtype)
            if R:
                full[row_idx] = compact
            return full.reshape((B, max_num) + trail)

        fc = _fc()

        def fill_ids(key: str, L: int):
            """-> ([R, L] compact rows, capped lengths). Native single-pass
            fill when the extension is available, else a C-level value walk:
            chain.from_iterable instead of a nested python genexpr (the
            per-value generator frames dominated collate at batch 256)."""
            if fc is not None:
                compact = np.zeros((R, L), np.int32)
                lens = np.zeros(R, np.int64)
                fc.fill_ids(items_flat, key, compact, lens, L)
                return compact, lens
            rows = [it[key] for it in items_flat]
            lens = np.fromiter(map(len, rows), np.int64, R)
            if (lens > L).any():
                rows = [
                    r[:L] if n > L else r for r, n in zip(rows, lens)
                ]
                np.minimum(lens, L, out=lens)
            vals = np.fromiter(
                chain.from_iterable(rows), np.int32, int(lens.sum())
            )
            compact = np.zeros((R, L), np.int32)
            compact[np.arange(L)[None, :] < lens[:, None]] = vals
            return compact, lens

        len_arr = None
        # id lists are shared by reference where the dataset emits the same
        # underlying sequence under several keys (glove/fasttext/phoc are
        # all the word-id list) — pack each distinct sequence once
        filled: Dict[str, tuple] = {}
        def alias_all(k1, k2):
            if fc is not None:
                return fc.alias_all(items_flat, k1, k2)
            return all(it[k1] is it[k2] for it in items_flat)

        scattered: Dict[str, np.ndarray] = {}
        for k in id_keys:
            src = next(
                (k2 for k2 in filled if alias_all(k2, k)),
                None,
            )
            filled[k] = filled[src] if src is not None else fill_ids(k, max_len)
            compact, lens = filled[k]
            # aliased sources emit the SAME output array: downstream
            # put_block detects the identity and ships ONE buffer over the
            # wire (the shared word-id grid is the largest key in a
            # flagship batch, and glove/fasttext/phoc usually all carry
            # it). Nothing in the runtime mutates collated grids in place.
            out[k] = scattered[src] if src is not None else scatter(
                compact, max_len
            )
            scattered[k] = out[k]
            if k == len_key:
                len_arr = lens
        if len_arr is None and R:
            len_arr = np.fromiter(
                (min(len(it[len_key]), max_len) for it in items_flat),
                np.int64, R,
            )
        out["len"] = scatter(
            (len_arr if len_arr is not None else np.zeros(0)).astype(np.int32)
        )
        if fc is not None:
            pos = np.zeros((R, 8), np.float32)
            fc.fill_f32(items_flat, "position", pos, 8)
        else:
            pos = (
                np.fromiter(
                    chain.from_iterable(it["position"] for it in items_flat),
                    np.float32, R * 8,
                ).reshape(R, 8)
                if R
                else np.zeros((0, 8), np.float32)
            )
        out["position"] = scatter(pos, 8)

        if has_bert:
            compact_bert, _ = fill_ids("bert", max_bert_len)
            out["bert"] = scatter(compact_bert, max_bert_len)
            # offsets: [(st, ed)] pairs per candidate word, clipped to the
            # bert length cap, ed >= st
            if fc is not None:
                compact_off = np.zeros((R, max_len, 2), np.int32)
                fc.fill_offsets(
                    items_flat, "bert_offsets", compact_off,
                    np.zeros(R, np.int64), max_len, max_bert_len,
                )
            else:
                offs = [it["bert_offsets"] for it in items_flat]
                counts = np.fromiter(map(len, offs), np.int64, R)
                if (counts > max_len).any():
                    offs = [
                        o[:max_len] if n > max_len else o
                        for o, n in zip(offs, counts)
                    ]
                    np.minimum(counts, max_len, out=counts)
                pairs = np.fromiter(
                    chain.from_iterable(chain.from_iterable(offs)),
                    np.int32,
                    int(counts.sum()) * 2,
                ).reshape(-1, 2)
                st = np.minimum(pairs[:, 0], max_bert_len - 1)
                ed = np.maximum(np.minimum(pairs[:, 1], max_bert_len), st)
                compact_off = np.zeros((R, max_len, 2), np.int32)
                wmask = np.arange(max_len)[None, :] < counts[:, None]
                compact_off[wmask] = np.stack([st, ed], axis=1)
            out["bert_offsets"] = scatter(compact_off, max_len, 2)

            out["bert_mask"] = (out["bert"] != 0).astype(np.int32)
            if self.dedup_frac > 0:
                self._add_dedup(out, B, max_num, max_bert_len)
        if self.compact:
            self._add_compact(out, B, max_num)
        return out

    def compact_sizes(self, B: int, max_num: int) -> Tuple[int, ...]:
        """Every ``cand_sel`` length this collator can emit for a
        [B, max_num] block, ascending and strictly below the no-win dense
        row count (serving warmup crosses these). A 3/4-ratio ladder, not
        halvings: candidate fill is commonly 50-75% of the grid, a region
        a power-of-2 ladder misses entirely (the batch then falls back to
        dense and compaction never fires). Each step still buys >= 25%."""
        if not self.compact:
            return ()
        total = B * max_num
        sizes, size = set(), float(total)
        for _ in range(max(1, self.compact_buckets)):
            size *= 0.75
            s = max(8, int(-(-size // 8) * 8))  # ceil to 8-aligned
            if s < total:
                sizes.add(s)
            if s <= 8:
                break
        return tuple(sorted(sizes))

    def _add_compact(self, out: Dict[str, np.ndarray], B: int, max_num: int):
        """Attach ``cand_sel`` [R-bucket] — flat indices (b * max_num + n)
        of the real candidate rows, padded with the out-of-bounds sentinel
        ``B * max_num`` — when a ladder bucket beats the dense row count."""
        num = out["num"]
        R = int(num.sum())
        sizes = self.compact_sizes(B, max_num)
        if not sizes or R == 0 or R > sizes[-1]:
            return  # compaction cannot beat the dense grid for this batch
        cap = _pick_bucket(sizes, R)
        mask = np.arange(max_num, dtype=np.int64)[None, :] < num[:, None]
        sel = np.full(cap, B * max_num, np.int32)
        sel[:R] = np.flatnonzero(mask.reshape(-1))
        out["cand_sel"] = sel

    def dedup_cap(self, B: int, max_num: int, frac: Optional[float] = None) -> int:
        """The 64-aligned unique-table cap for a [B, max_num] block."""
        if frac is None:
            frac = self.dedup_frac
        return max(64, int(np.ceil(frac * B * max_num / 64.0)) * 64)

    def dedup_sizes(self, B: int, max_num: int) -> Tuple[int, ...]:
        """Every unique-table ROW count this collator can emit for a
        [B, max_num] block — the bucket ladder under the cap, or () when
        dedup can never attach (off, or the cap can't beat the dense
        shape). Serving warmup runs these crossed with
        ``dedup_len_ladder`` plus the dense fallback
        (`serve.InferenceEngine.warmup`)."""
        if self.dedup_frac <= 0:
            return ()
        cap = self.dedup_cap(B, max_num)
        if cap >= B * max_num and self.dedup_frac < 1.0:
            return ()
        return self._dedup_ladder(cap)

    def _dedup_ladder(self, cap: int) -> Tuple[int, ...]:
        """Unique-table sizes to pad to, ascending, largest = cap. With
        `bert_dedup_buckets` > 1 (default 2) the table pads to the smallest
        64-aligned power-of-2 step that fits instead of always the cap —
        the batch profile showed ~half the encoded unique rows were pad at
        realistic duplication, and BERT-on-uniques is ~76% of the batch.
        Program count stays bounded by the ladder length."""
        steps, size = [], cap
        for _ in range(max(1, self.dedup_buckets)):
            steps.append(size)
            if size <= 64:
                break
            size = max(64, ((size // 2 + 63) // 64) * 64)
        return tuple(sorted(set(steps)))

    def dedup_len_ladder(self, max_bert_len: int) -> Tuple[int, ...]:
        """Wordpiece-axis sizes the unique table can pad to, ascending,
        largest = the block's bert-length cap. Halving steps, 8-aligned
        (sublane-friendly), skipping steps that save under 25% (not worth
        a compiled program). Single-entry ladder when
        ``bert_dedup_len_buckets 1`` restores the fixed-width table."""
        return _halving_ladder(
            max_bert_len, self.dedup_len_buckets, align=8, floor=8
        )

    def _add_dedup(self, out: Dict[str, np.ndarray], B, max_num, max_bert_len,
                   frac: Optional[float] = None):
        """Attach bert_unique [cap-bucket, Lb] + bert_inverse [B, N] +
        bert_unique_offsets [cap-bucket, W, 2] when the batch's unique rows
        fit the configured cap.

        The dedup key is the JOINT (piece ids, word offsets) row: the model
        pools wordpiece spans into word vectors ON THE UNIQUE TABLE and
        expands the (much smaller) pooled word rows to candidates — exact
        only when rows sharing an encoder row also share word spans. In
        practice duplicates are repeated *strings* (same tokenization, same
        spans), so the joint key costs ~no unique-count inflation."""
        if frac is None:
            frac = self.dedup_frac
        cap = self.dedup_cap(B, max_num, frac)
        if cap >= B * max_num and frac < 1.0:
            # the 64-row-aligned cap is no smaller than the dense batch at
            # these shapes (tiny test batches): dedup cannot win, stay dense
            # (frac >= 1 forces the dedup artifacts anyway, for tests) —
            # checked BEFORE the np.unique row sort, which is the expensive
            # part of this path
            return
        flat = out["bert"].reshape(B * max_num, max_bert_len)
        if "bert_offsets" in out:
            offs_flat = out["bert_offsets"].reshape(B * max_num, -1)
            joint = np.concatenate([flat, offs_flat], axis=1)
            unique_joint, inverse = unique_rows(joint)
            unique = np.ascontiguousarray(unique_joint[:, :max_bert_len])
            unique_offs = unique_joint[:, max_bert_len:]
        else:
            # pieces-only key (no offsets in this block): the model then
            # expands the unique ENCODER rows before pooling instead of
            # pooling on the unique table
            unique, inverse = unique_rows(flat)
            unique_offs = None
        if unique.shape[0] > cap:
            # fallback: model uses the dense path (separate compiled
            # program; frequent flips between the two waste compile time)
            self.dedup_fallbacks += 1
            log.log(
                logging.WARNING if self.dedup_fallbacks == 1 else logging.DEBUG,
                "bert dedup fallback #%d: %d unique rows > cap %d "
                "(bert_dedup_frac %.3g of %d rows); raise bert_dedup_frac "
                "if this is common",
                self.dedup_fallbacks, unique.shape[0], cap,
                self.dedup_frac, B * max_num,
            )
            return
        size = _pick_bucket(self._dedup_ladder(cap), unique.shape[0])
        # wordpiece-axis bucket: trim trailing all-pad columns to the
        # smallest ladder width that holds the longest row (exact — rows
        # are left-aligned and BERT output per row ignores trailing pad)
        nz_cols = (unique != 0).any(axis=0)
        need_l = int(nz_cols.nonzero()[0][-1]) + 1 if nz_cols.any() else 1
        lsz = _pick_bucket(self.dedup_len_ladder(max_bert_len), need_l)
        unique = unique[:, :lsz]
        if self.pack:
            self._add_pack(out, unique.astype(np.int32), size, lsz)
        else:
            pad = np.zeros((size - unique.shape[0], lsz), dtype=np.int32)
            out["bert_unique"] = np.concatenate([unique.astype(np.int32), pad])
        if unique_offs is not None:
            k = unique_offs.shape[0]
            uo = np.zeros((size, unique_offs.shape[1]), dtype=np.int32)
            uo[:k] = unique_offs
            out["bert_unique_offsets"] = uo.reshape(size, -1, 2)
        out["bert_inverse"] = inverse.reshape(B, max_num).astype(np.int32)

    def pack_row_ladder(self, size: int) -> Tuple[int, ...]:
        """Packed-row counts this collator can emit for a ``size``-row
        unique bucket, ascending (8-aligned halving steps; largest = size,
        the no-win upper bound)."""
        return _halving_ladder(size, self.pack_buckets, align=8, floor=8)

    def _add_pack(self, out: Dict[str, np.ndarray], unique, size, lsz):
        """Bin-pack the unique rows into shared encoder rows.

        Emits ``bert_packed`` / ``bert_packed_seg`` / ``bert_packed_pos``
        [R-bucket, Lp] plus ``bert_unpack`` [size, lsz] (flat indices into
        the packed token grid for each unique row's tokens; pad tokens
        point at 0, which downstream pooling weights never read).

        Best-fit-decreasing with bins tracked by remaining capacity —
        O(U * Lp) worst case, vectorized token scatter."""
        U = unique.shape[0]
        lens = (unique != 0).sum(axis=1).astype(np.int64)     # [U]
        Lp = max(self.pack_len, lsz)
        order = np.argsort(-lens, kind="stable")
        bin_of = np.zeros(U, np.int64)
        off_of = np.zeros(U, np.int64)
        seg_of = np.zeros(U, np.int64)
        # bins_by_rem[r] = stack of bin ids with r tokens of room left
        bins_by_rem = [[] for _ in range(Lp + 1)]
        bin_used: list = []     # tokens used per bin
        bin_count: list = []    # segments placed per bin
        for u in order:
            l = int(lens[u])
            if l == 0:
                continue        # empty rows occupy nothing
            b = -1
            for r in range(l, Lp + 1):   # best fit: smallest adequate room
                if bins_by_rem[r]:
                    b = bins_by_rem[r].pop()
                    break
            if b < 0:
                b = len(bin_used)
                bin_used.append(0)
                bin_count.append(0)
            bin_of[u] = b
            off_of[u] = bin_used[b]
            bin_count[b] += 1
            seg_of[u] = bin_count[b]
            bin_used[b] += l
            bins_by_rem[Lp - bin_used[b]].append(b)
        R = _pick_bucket(self.pack_row_ladder(size), max(1, len(bin_used)))
        # vectorized token scatter: flat src positions in `unique`, flat
        # dst positions in the packed grid, per-token local offsets
        total = int(lens.sum())
        starts = np.zeros(U, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        row_rep = np.repeat(np.arange(U, dtype=np.int64), lens)
        delta = np.arange(total, dtype=np.int64) - np.repeat(starts, lens)
        src = row_rep * lsz + delta
        dst = bin_of[row_rep] * Lp + off_of[row_rep] + delta
        packed = np.zeros(R * Lp, np.int32)
        seg = np.zeros(R * Lp, np.int32)
        pos = np.zeros(R * Lp, np.int32)
        unpack = np.zeros(U * lsz, np.int32)
        packed[dst] = unique.reshape(-1)[src]
        seg[dst] = seg_of[row_rep]
        pos[dst] = delta
        unpack[src] = dst
        out["bert_packed"] = packed.reshape(R, Lp)
        out["bert_packed_seg"] = seg.reshape(R, Lp)
        out["bert_packed_pos"] = pos.reshape(R, Lp)
        up = unpack.reshape(U, lsz)
        if U < size:
            up = np.concatenate([up, np.zeros((size - U, lsz), np.int32)])
        out["bert_unpack"] = up

    # -- question block --------------------------------------------------
    def _collate_q(self, q_list: Sequence[dict]) -> Dict[str, np.ndarray]:
        B = len(q_list)
        Lq, Lqb = self.cfg.max_q_len, self.cfg.max_q_bert_len
        # exact wordpiece-width bucket (the q WORD axis keeps its cap —
        # it feeds the pad-sensitive question BiLSTMs)
        if len(self.q_bert_buckets) > 1 and "bert" in q_list[0]:
            need = max(
                (min(len(q["bert"]), Lqb) for q in q_list), default=1
            )
            Lqb = _pick_bucket(self.q_bert_buckets, need)
        keys = q_list[0].keys()
        out: Dict[str, np.ndarray] = {}
        for k in keys:
            if k == "bert_offsets":
                out[k] = _pad_offsets([q["bert_offsets"] for q in q_list], Lq, Lqb)
            elif k == "bert":
                out[k] = _pad_ids([q[k] for q in q_list], Lqb)
            elif k in ("img_features", "img_spatials"):
                out[k] = np.stack([np.asarray(q[k], np.float32) for q in q_list])
            else:
                out[k] = _pad_ids([q[k] for q in q_list], Lq)
        if "bert" in out:
            out["bert_mask"] = (out["bert"] != 0).astype(np.int32)
            if self.q_pack and self.pack and self.dedup_frac > 0:
                # pack the question rows through the same machinery
                # (max_num=1; frac=1.0 so the table ALWAYS attaches — the
                # win is packing, not dedup); see __init__ q_pack note
                self._add_dedup(out, B, 1, out["bert"].shape[-1], frac=1.0)
                if "bert_inverse" in out:
                    out["bert_inverse"] = out["bert_inverse"].reshape(B)
        return out

    # -- labels ----------------------------------------------------------
    def _collate_gt(
        self, gt_list: Sequence[Optional[dict]], num_scores: Optional[int] = None
    ) -> Optional[np.ndarray]:
        if not gt_list or gt_list[0] is None:
            return None
        B = len(gt_list)
        num_scores = self.num_scores if num_scores is None else num_scores
        out = np.zeros((B, num_scores), dtype=np.float32)
        body = num_scores - (
            1 if "label_no_answer" in self.cfg.opt else 0
        )
        for b, gt in enumerate(gt_list):
            vals = gt["values"][:body]
            out[b, : len(vals)] = vals
            if gt["no_answer"] is not None:
                out[b, -1] = gt["no_answer"]
        return out

    # -- entry point -----------------------------------------------------
    def _ocr_buckets(self, ocr_items: Sequence[Sequence[dict]]) -> Tuple[int, int]:
        """(num, bert_len) bucket for this batch's OCR block."""
        if len(self.ocr_num_buckets) == 1 and len(self.ocr_len_buckets) == 1:
            return self.ocr_num_buckets[0], self.ocr_len_buckets[0]
        need_n = max((len(items) for items in ocr_items), default=1)
        need_l = 1
        for items in ocr_items:
            for item in items:
                if "bert" in item:
                    need_l = max(need_l, len(item["bert"]))
        return (
            _pick_bucket(self.ocr_num_buckets, need_n),
            _pick_bucket(self.ocr_len_buckets, need_l),
        )

    def __call__(self, batch: Sequence[dict]):
        cfg = self.cfg
        q = self._collate_q([t["q"] for t in batch])
        ocr_items = [t["ocr"] for t in batch]
        n_bucket, l_bucket = self._ocr_buckets(ocr_items)
        ocr = self._collate_items(
            ocr_items, n_bucket, self.ocr_word_buckets, l_bucket,
        )
        od = self._collate_items(
            [t["od"] for t in batch],
            cfg.max_od_num, self.od_word_buckets, cfg.max_od_bert_len,
        )
        # targets track the bucketed score width (fixed/yesno/no-answer
        # slots are unaffected; masked pad columns carry zero labels)
        gt = self._collate_gt(
            [t["gt"] for t in batch],
            num_scores=self.num_scores - cfg.max_ocr_num + n_bucket,
        )
        extra = [t["extra_info"] for t in batch]
        if self.narrow:
            for block in (q, ocr, od):
                narrow_block(block, self.narrow_word16, self.narrow_bert16)
        return q, ocr, od, gt, extra
