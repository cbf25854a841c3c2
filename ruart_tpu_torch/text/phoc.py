"""PHOC string encoding — host side. Port of ``ruart_tpu/text/phoc.py``.

Three implementations with one contract (604-dim binary vector, layout and
>=0.5-overlap rule of `Utils/cphoc.c:12-113`):

* :func:`build_phoc` / :func:`build_phoc_batch` — the C++ encoder
  (``native/phoc.cc``, built by ``native/build.py`` at first use) over
  ctypes; the batch entry point encodes a whole word list in one call.
* :func:`build_phoc_py` — the float32 oracle in Python, to check the
  native encoder.
* the tensor op on an explicit device lives in :mod:`ruart_tpu_torch.ops.phoc`.

Input filtering matches the reference wrapper (`Utils/CoQAUtils.py:68-73`):
lowercase, strip every character outside [a-z0-9], then encode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from ruart_tpu_torch.core.constants import (
    PHOC_ALPHABET,
    PHOC_BIGRAMS,
    PHOC_DIM,
    PHOC_UNIGRAMS,
)


@functools.lru_cache(maxsize=1)
def _get_lib() -> ctypes.CDLL:
    from ruart_tpu_torch.native.build import ensure_built

    lib = ctypes.CDLL(ensure_built())
    lib.ruart_phoc.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ruart_phoc.restype = ctypes.c_int
    lib.ruart_phoc_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ruart_phoc_batch.restype = ctypes.c_int
    return lib


def filter_token(token: str) -> str:
    """Lowercase + keep only [a-z0-9] (`CoQAUtils.py:69-71`)."""
    token = token.lower().strip()
    return "".join(c for c in token if c in PHOC_ALPHABET)


def build_phoc(token: str) -> np.ndarray:
    """Encode one (unfiltered) token -> float32 [604]."""
    word = filter_token(token).encode("ascii")
    out = np.zeros(PHOC_DIM, dtype=np.float32)
    rc = _get_lib().ruart_phoc(
        word, len(word), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    if rc != 0:
        raise RuntimeError(f"unknown character in PHOC input {token!r}")
    return out


def build_phoc_batch(tokens: Sequence[str]) -> np.ndarray:
    """Encode many tokens -> float32 [n, 604] in one native call."""
    words = [filter_token(t).encode("ascii") for t in tokens]
    n = len(words)
    out = np.zeros((n, PHOC_DIM), dtype=np.float32)
    if n == 0:
        return out
    buf = b"".join(words)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(w) for w in words], out=offsets[1:])
    _get_lib().ruart_phoc_batch(
        buf,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def build_phoc_embedding(vocab: Sequence[str]) -> np.ndarray:
    """PHOC table for a vocabulary: row i = phoc(vocab[i])
    (`CoQAUtils.py:75-87`; every row is overwritten by its PHOC vector,
    including the reserved rows, whose names filter to e.g. 'pad')."""
    return build_phoc_batch(list(vocab))


# ---------------------------------------------------------------------------
# Float32 oracle in Python
# ---------------------------------------------------------------------------

_UNI_INDEX = {c: i for i, c in enumerate(PHOC_UNIGRAMS)}
_BI_INDEX = {b: i for i, b in enumerate(PHOC_BIGRAMS)}
_LEVELS = (2, 3, 4, 5)
_LEVEL_OFFSET = {2: 0, 3: 2, 4: 5, 5: 9}


def build_phoc_py(token: str) -> np.ndarray:
    """Reference oracle in float32 arithmetic (matches C bit-for-bit on
    region-boundary cases like len-3 strings where 1/6 overlap rounds just
    under 0.5 in float32)."""
    word = filter_token(token)
    n = len(word)
    out = np.zeros(PHOC_DIM, dtype=np.float32)
    f = np.float32
    for index, ch in enumerate(word):
        c0 = f(index) / f(n)
        c1 = f(index + 1) / f(n)
        ci = _UNI_INDEX[ch]
        for level in _LEVELS:
            for region in range(level):
                r0 = f(region) / f(level)
                r1 = f(region + 1) / f(level)
                frac = (min(c1, r1) - max(c0, r0)) / (c1 - c0)
                if frac >= f(0.5):
                    out[(_LEVEL_OFFSET[level] + region) * 36 + ci] = 1.0
    for i in range(n - 1):
        bi = _BI_INDEX.get(word[i : i + 2])
        if bi is None:
            continue
        o0 = f(i) / f(n)
        o1 = f(i + 2) / f(n)
        for region in range(2):
            r0 = f(region) / f(2)
            r1 = f(region + 1) / f(2)
            if (min(o1, r1) - max(o0, r0)) / (o1 - o0) >= f(0.5):
                out[504 + region * 50 + bi] = 1.0
    return out
