"""WordPiece tokenization (BERT-compatible).

From-scratch implementation with the same contract as the reference's
vendored 2018 tokenizer (`Models/Bert/tokenization.py:86-325`):

* :class:`BasicTokenizer` — invalid-char/control cleanup, CJK spacing,
  optional lowercasing with accent stripping (NFD + Mn removal),
  punctuation splitting (ASCII-symbol ranges + Unicode P*).
* :class:`WordpieceTokenizer` — greedy longest-match-first ``##`` pieces,
  per-token ``[UNK]`` when a word exceeds 100 chars or has no valid
  decomposition.
* :class:`WordPieceTokenizer` — the end-to-end pipeline plus vocab id
  mapping and the ``bertify`` helper that produces ids + word-span offsets
  the way `Utils/VQA_Dataset.py:415-436` does.
"""

from __future__ import annotations

import unicodedata
from typing import Any, Dict, List, Sequence, Tuple


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punct(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _space_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.extend((" ", ch, " "))
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordpieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, token: str) -> List[str]:
        out: List[str] = []
        for word in token.strip().split():
            if len(word) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            start = 0
            pieces: List[str] = []
            bad = False
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([self.unk_token] if bad else pieces)
        return out


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """vocab.txt -> token->id, line order = id (`tokenization.py:60-73`)."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            vocab[line.rstrip("\n").strip()] = idx
    return vocab


class WordPieceTokenizer:
    """End-to-end BERT tokenizer + the reference's bertify contract."""

    CLS = "[CLS]"
    SEP = "[SEP]"
    UNK = "[UNK]"
    PAD = "[PAD]"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        # word -> piece tuple. Scene-text pipelines re-tokenize the same
        # strings constantly (candidates repeat across samples and epochs;
        # ~90% of dataset __getitem__ time was tokenization before this);
        # tokenization is pure so a cache is exact. Bounded to keep a
        # pathological stream from growing without limit.
        self._cache: Dict[str, tuple] = {}
        # whole-candidate bertify cache: scene-text candidates repeat
        # massively across samples (batch-global uniqueness is 6-12%,
        # PROGRESS_NOTES round 2), and bertify is pure — so the full
        # ([CLS] pieces [SEP] ids, offsets) result is cached per word
        # tuple and shared as immutable tuples (collate reads rows
        # without mutating them)
        self._bertify_cache: Dict[Any, tuple] = {}
        self._cache_cap = 1 << 20
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_file(cls, vocab_file: str, do_lower_case: bool = True):
        return cls(load_vocab(vocab_file), do_lower_case)

    def tokenize(self, text: str) -> List[str]:
        cached = self._cache.get(text)
        if cached is None:
            out: List[str] = []
            for tok in self.basic.tokenize(text):
                out.extend(self.wordpiece.tokenize(tok))
            cached = tuple(out)
            if len(self._cache) < self._cache_cap:
                self._cache[text] = cached
        return list(cached)

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab[t] for t in tokens]

    def bertify(
        self, words
    ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Tokenize a word list (or raw string) into
        ([CLS] pieces [SEP]) ids plus per-word (start, end) piece spans,
        exactly like `VQA_Dataset.bertify:415-436` (including the
        ``[1, 1]`` offsets quirk for an empty word list). Results are
        cached per input and returned as shared immutable tuples."""
        key = words if isinstance(words, str) else tuple(words)
        cached = self._bertify_cache.get(key)
        if cached is not None:
            return cached
        pieces = [self.CLS]
        offsets: List[Tuple[int, int]] = []
        if isinstance(words, str):
            pieces.extend(self.tokenize(words))
        else:
            for word in words:
                now = self.tokenize(word)
                offsets.append((len(pieces), len(pieces) + len(now)))
                pieces.extend(now)
            if len(words) == 0:
                offsets = [(1, 1)]
        pieces.append(self.SEP)
        cached = (tuple(self.convert_tokens_to_ids(pieces)), tuple(offsets))
        if len(self._bertify_cache) < self._cache_cap:
            self._bertify_cache[key] = cached
        return cached


def build_demo_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """A tiny self-contained WordPiece vocabulary for tests/benchmarks:
    specials, ascii chars, their ## continuations, and optional whole words.
    Greedy longest-match over this vocab always succeeds on ASCII input."""
    tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = "abcdefghijklmnopqrstuvwxyz0123456789'-.,!?$%&()/:;"
    tokens.extend(list(chars))
    tokens.extend("##" + c for c in chars)
    for w in extra_words:
        if w not in tokens:
            tokens.append(w)
    return {t: i for i, t in enumerate(tokens)}
