"""The port's native collator (``native/fastcollate.cc``, loaded by
``data/collate.py``) against its own numpy path and the JAX package's
collate, on the CPU. Mirrors ``tests/test_data.py``'s native tests: whole
batches byte-equal (dedup and packing tables, offset clipping), the
unique-rows and padding helpers, and seeded fuzz of every fill loop
(empty and over-long rows, tuples and lists, negative and cap-crossing
offsets). Also: the build is named after the interpreter and apart from
the JAX package's extension, ``RUART_NO_NATIVE=1`` opts out, and a failed
build warns with the compiler's error and keeps the numpy path."""

import logging
import sysconfig

import numpy as np
import pytest
import torch

from ruart_tpu.core.config import Config as JaxConfig
from ruart_tpu.data import collate as JC
from ruart_tpu_torch.core.config import Config
from ruart_tpu_torch.data import collate as C
from ruart_tpu_torch.data.dataset import VQADataset
from ruart_tpu_torch.data.preprocess import Preprocessor
from ruart_tpu_torch.data.synthetic import make_synthetic_raw_dataset
from ruart_tpu_torch.native import build
from ruart_tpu_torch.text.wordpiece import WordPieceTokenizer, build_demo_vocab
from tests.test_torch_port_collate import _opt

torch.set_num_threads(2)


@pytest.fixture
def numpy_path(monkeypatch):
    """Run the block under the numpy path: ``numpy_path(fn)``."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(C, "_fc", lambda: None)
            return fn(*args)
    return run


def _items(extra, n=9, seed=1):
    opt = _opt(extra)
    cfg = Config(opt)
    pre = Preprocessor(cfg)
    raw = make_synthetic_raw_dataset(4, seed=seed, n_ocr_range=(3, 9), n_es=6)
    data = pre._process_data(raw["data"])
    pre.train_vocab = pre._build_vocab(data)
    pre._assign_ids(data)
    ds = VQADataset(data, cfg, mode="train",
                    tokenizer=WordPieceTokenizer(build_demo_vocab()))
    return opt, [ds[i % len(ds)] for i in range(n)]


def _check(a, b, path):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _check(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _check(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def test_extension_is_the_ports_own():
    assert C.native_active()
    fc = C._fc()
    assert fc.__name__ == "_ruart_torch_fastcollate"
    assert fc.__file__ == str(build.FASTCOLLATE_LIBRARY)
    assert fc.__file__.endswith(sysconfig.get_config_var("EXT_SUFFIX"))
    assert str(build.BUILD_DIR) in fc.__file__
    assert JC._FC is not None and JC._FC.__name__ == "_ruart_fastcollate"
    assert JC._FC is not fc


@pytest.mark.parametrize("layout", [
    {"bert_pack": 1, "bert_dedup_frac": 1},
    {"bert_pack": 0, "bert_dedup_frac": 1},
    {"bert_dedup_frac": 0, "cand_compact": 0, "max_ocr_bert_len": 4},
])
def test_native_collate_matches_numpy_and_jax(layout, numpy_path):
    """Whole batches byte-equal: the port native, the port's numpy path,
    and the JAX package's collate (the last caps ``max_ocr_bert_len``
    below the pieces, so offsets are clipped)."""
    opt, items = _items(layout)
    native = C.Collator(Config(dict(opt)))(items)
    pure = numpy_path(C.Collator(Config(dict(opt))), items)
    jax_out = JC.Collator(JaxConfig(dict(opt)))(items)
    for i, (na, pu, jx) in enumerate(zip(native, pure, jax_out)):
        _check(na, pu, f"out[{i}]")
        _check(na, jx, f"out[{i}]")
    if layout.get("bert_dedup_frac"):
        assert "bert_inverse" in native[1]
        assert ("bert_packed" in native[1]) == bool(layout["bert_pack"])


def test_native_unique_and_pad_match_numpy(numpy_path):
    rng = np.random.RandomState(0)
    flat = rng.randint(0, 3, (64, 7)).astype(np.int32)
    un, inv = C.unique_rows(flat)
    un2, inv2 = numpy_path(C.unique_rows, flat)
    assert (un == un2).all() and (inv == inv2).all()
    jun, jinv = JC.unique_rows(flat)
    assert (un == jun).all() and (inv == jinv).all()
    rows = [list(rng.randint(0, 9, rng.randint(0, 11))) for _ in range(33)]
    assert (C._pad_ids(rows, 6) == numpy_path(C._pad_ids, rows, 6)).all()
    assert C.unique_rows(flat[:0])[0].shape == (0, 7)


def test_native_fill_fuzz_parity(numpy_path):
    """Seeded ragged inputs through the native fill loops match the numpy
    fallbacks element for element."""
    fc = C._fc()
    rng = np.random.RandomState(11)
    for trial in range(20):
        R = int(rng.randint(0, 40))
        L = int(rng.randint(1, 9))
        items = []
        for _ in range(R):
            n = int(rng.randint(0, 12))
            ids = [int(v) for v in rng.randint(0, 30000, n)]
            offs = [
                (int(rng.randint(-2, 12)), int(rng.randint(-2, 14)))
                for _ in range(int(rng.randint(0, 7)))
            ]
            items.append({
                "ids": tuple(ids) if rng.rand() < 0.3 else ids,
                "pos": [float(v) for v in rng.randn(8)],
                "off": offs,
            })
        vals = np.zeros((R, L), np.int32)
        lens = np.zeros(R, np.int64)
        fc.fill_ids(items, "ids", vals, lens, L)
        ref = numpy_path(C._pad_ids, [list(it["ids"]) for it in items], L)
        assert (vals == ref).all()
        assert all(lens[i] == min(len(items[i]["ids"]), L) for i in range(R))
        pos = np.zeros((R, 8), np.float32)
        fc.fill_f32(items, "pos", pos, 8)
        ref_pos = np.array([it["pos"] for it in items], np.float32).reshape(
            R, 8) if R else pos
        assert (pos == ref_pos).all()
        MW, MB = int(rng.randint(1, 8)), int(rng.randint(1, 10))
        off_c = np.zeros((R, MW, 2), np.int32)
        cnt = np.zeros(R, np.int64)
        fc.fill_offsets(items, "off", off_c, cnt, MW, MB)
        ref_off = numpy_path(C._pad_offsets, [it["off"] for it in items], MW, MB)
        assert (off_c == ref_off).all()
        assert all(cnt[i] == min(len(items[i]["off"]), MW) for i in range(R))
        assert fc.alias_all(items, "ids", "ids")
        assert fc.alias_all(items, "ids", "pos") == (R == 0)


def test_opt_out_and_failed_build(monkeypatch, tmp_path, caplog, numpy_path):
    """``RUART_NO_NATIVE=1`` keeps the numpy path; so does a build that
    fails, with a warning that carries the compiler's error. Either way
    the collator's output is unchanged."""
    opt, items = _items({})
    want = numpy_path(C.Collator(Config(dict(opt))), items)
    try:
        C._fc.cache_clear()
        monkeypatch.setenv("RUART_NO_NATIVE", "1")
        assert not C.native_active()
        monkeypatch.delenv("RUART_NO_NATIVE")
        C._fc.cache_clear()
        bad = tmp_path / "broken.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(build, "FASTCOLLATE_SOURCE", bad)
        monkeypatch.setattr(build, "FASTCOLLATE_LIBRARY",
                            tmp_path / "_broken.so")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        with caplog.at_level(logging.WARNING, logger=C.log.name):
            assert not C.native_active()
        assert "g++ failed" in caplog.text and "broken.cc" in caplog.text
        _check(C.Collator(Config(dict(opt)))(items), want, "out")
        assert list(tmp_path.iterdir()) == [bad]  # no temporary left behind
    finally:
        C._fc.cache_clear()
    monkeypatch.undo()
    assert C.native_active()
