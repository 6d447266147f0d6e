"""The tokenizers (the port's own copy of lr2ppo_tpu/data/tokenizers.py):
the special-token map, the vocab-file base tokenizer, char, space, bert
(wordpiece), bpe (GPT-2 byte-level, which needs the `regex` package,
imported at first use), the pure-Python sentencepiece Unigram model and
XLMRobertaTokenizer, the virtual (empty) tokenizer of the vision models,
the VQGAN image tokenizer (towers/vqgan.py) and the text_image tokenizer,
with `str2tokenizer` naming them as the JAX package's does.

XLMRobertaTokenizer's backends, in preference order: the `sentencepiece`
package, the HF `tokenizers` runtime (tokenizer.json), and the
self-contained `SentencePieceUnigram` (its own protobuf wire parser,
NormalizerSpec-driven NFKC/NMT normalization, byte fallback and Viterbi
segmentation). The two packages are optional and imported at first use; the
Unigram backend needs neither.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

DEFAULT_SPECIALS = {
    "pad_token": "<pad>",
    "unk_token": "<unk>",
    "cls_token": "<s>",
    "sep_token": "</s>",
    "mask_token": "<mask>",
}


def load_special_tokens(path: Optional[str] = None) -> Dict[str, str]:
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            return {**DEFAULT_SPECIALS, **json.load(f)}
    return dict(DEFAULT_SPECIALS)


def _count_tokens(corpus_path: str, tokenizer, start: int,
                  end: Optional[int]) -> Dict[str, int]:
    """Token counts of the corpus's lines [start, end)."""
    counts: Dict[str, int] = {}
    with open(corpus_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i < start:
                continue
            if end is not None and i >= end:
                break
            for t in tokenizer.tokenize(line, use_vocab=False):
                counts[t] = counts.get(t, 0) + 1
    return counts


def _parallel_token_counts(corpus_path: str, tokenizer,
                           workers_num: int) -> Dict[str, int]:
    """Counts of `workers_num` line ranges in a fork pool, merged (the
    reference's vocab.py worker/union_workers, :40-111)."""
    from multiprocessing import get_context

    with open(corpus_path, encoding="utf-8") as f:
        lines_num = sum(1 for _ in f)
    bounds = [(i * lines_num // workers_num,
               (i + 1) * lines_num // workers_num)
              for i in range(workers_num)]
    with get_context("fork").Pool(workers_num) as pool:
        parts = pool.starmap(
            _count_tokens,
            [(corpus_path, tokenizer, s, e) for s, e in bounds])
    merged: Dict[str, int] = {}
    for part in parts:
        for w, c in part.items():
            merged[w] = merged.get(w, 0) + c
    return merged


class Vocab:
    """token <-> id maps; one token per line (vocab.py:8-38)."""

    def __init__(self):
        self.w2i: Dict[str, int] = {}
        self.i2w: List[str] = []

    def load(self, path: str) -> "Vocab":
        with open(path, encoding="utf-8") as f:
            for index, line in enumerate(f):
                w = (line.strip("\r\n").split()[0] if line.strip()
                     else line.strip("\r\n"))
                self.w2i[w] = index
                self.i2w.append(w)
        return self

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for w in self.i2w:
                f.write(w + "\n")

    def add(self, w: str) -> int:
        if w not in self.w2i:
            self.w2i[w] = len(self.i2w)
            self.i2w.append(w)
        return self.w2i[w]

    @classmethod
    def build(cls, corpus_path: str, tokenizer, min_count: int = 1,
              specials: Optional[List[str]] = None,
              workers_num: int = 1) -> "Vocab":
        """The vocabulary of a corpus (reference vocab.py:40-111): the
        specials first, then every token counted at least `min_count`
        times, by count (descending) and then by token. `workers_num > 1`
        counts line ranges in a fork pool and merges the counts."""
        if workers_num > 1:
            counts = _parallel_token_counts(corpus_path, tokenizer,
                                            workers_num)
        else:
            counts = _count_tokens(corpus_path, tokenizer, 0, None)
        v = cls()
        for s in (specials or list(DEFAULT_SPECIALS.values())):
            v.add(s)
        for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= min_count:
                v.add(w)
        return v

    def get(self, w: str) -> int:
        return self.w2i[w]

    def __len__(self) -> int:
        return len(self.i2w)


_SPECIAL_ALTERNATES = {
    # XLM-R-style defaults <-> BERT-style vocab spellings: when the
    # configured special is absent from a loaded vocab, fall back to a
    # spelling the vocab actually contains — otherwise every OOV word
    # would silently map to vocab.get(unk, 0) == [PAD]
    "unk_token": ["<unk>", "[UNK]"],
    "pad_token": ["<pad>", "[PAD]"],
    "cls_token": ["<s>", "[CLS]"],
    "sep_token": ["</s>", "[SEP]"],
    "mask_token": ["<mask>", "[MASK]"],
}


class BaseTokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 special_tokens_path: Optional[str] = None):
        self.specials = load_special_tokens(special_tokens_path)
        self.vocab: Dict[str, int] = {}
        if vocab_path:
            self.vocab = Vocab().load(vocab_path).w2i
        if self.vocab:
            for key, alts in _SPECIAL_ALTERNATES.items():
                if self.specials.get(key) not in self.vocab:
                    for alt in alts:
                        if alt in self.vocab:
                            self.specials[key] = alt
                            break
        self.unk = self.specials["unk_token"]
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

    def tokenize(self, text: str, use_vocab: bool = True) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk_id = self.vocab.get(self.unk, 0)
        return [self.vocab.get(t, unk_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.inv_vocab.get(i, self.unk) for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))


class CharTokenizer(BaseTokenizer):
    def tokenize(self, text, use_vocab=True):
        toks = list(text.strip())
        if use_vocab:
            return [t if t in self.vocab else self.unk for t in toks]
        return toks


class SpaceTokenizer(BaseTokenizer):
    def tokenize(self, text, use_vocab=True):
        toks = text.strip().split(" ")
        if use_vocab:
            return [t if t in self.vocab else self.unk for t in toks]
        return toks


class BertTokenizer(BaseTokenizer):
    """Basic (whitespace + punctuation + CJK) split then greedy wordpiece
    (reference tokenizers.py:251-270 path)."""

    def __init__(self, vocab_path=None, special_tokens_path=None,
                 lower: bool = True, max_chars_per_word: int = 100):
        super().__init__(vocab_path, special_tokens_path)
        self.lower = lower
        self.max_chars = max_chars_per_word

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        # full reference BasicTokenizer range set incl. Extensions B-F +
        # compatibility ideographs (tokenizers.py _is_chinese_char)
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _basic(self, text: str) -> List[str]:
        if self.lower:
            text = text.lower()
        text = unicodedata.normalize("NFD", text)
        # strip accents (Mn) and control chars (Cc/Cf, keeping \t\n\r as
        # whitespace) like the reference BasicTokenizer._clean_text
        text = "".join(
            c for c in text
            if unicodedata.category(c) != "Mn"
            and (c in "\t\n\r"
                 or not unicodedata.category(c).startswith("C")))
        out, cur = [], []
        for ch in text:
            if ch.isspace():
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif self._is_punct(ch) or self._is_cjk(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text, use_vocab=True):
        out: List[str] = []
        for word in self._basic(text.strip()):
            out.extend(self._wordpiece(word) if use_vocab else [word])
        return out


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte <-> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer(BaseTokenizer):
    """GPT-2 byte-level BPE (reference tokenizers.py:272-338), reading the
    shipped huggingface_gpt2_vocab.txt / _merges.txt assets."""

    def __init__(self, vocab_path=None, merges_path=None,
                 special_tokens_path=None):
        super().__init__(vocab_path, special_tokens_path)
        import regex

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks: Dict[tuple, int] = {}
        if merges_path:
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")[1:-1]
            self.bpe_ranks = {tuple(m.split()): i
                              for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {}
        self.pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
            r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text, use_vocab=True):
        import regex

        out: List[str] = []
        for token in regex.findall(self.pat, text):
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            out.extend(self._bpe(mapped).split(" "))
        return out

    def decode(self, tokens: List[str]) -> str:
        text = "".join(tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")


class SentencePieceUnigram:
    """Pure-Python sentencepiece Unigram model — no `sentencepiece`
    dependency, so feature extraction runs with the standard library
    alone.

    Loads either a real sentencepiece `.model` file (the protobuf wire
    format is parsed directly: ModelProto.pieces = repeated field 1,
    each SentencePiece = {piece: field 1 (string), score: field 2
    (float32), type: field 3 (varint)}, NormalizerSpec = field 3) or a
    plain vocab file with `token<TAB>score` (score optional) per line.

    Fidelity to real sentencepiece (reference tokenizers.py:340-420
    tokenizes through the actual spm runtime):

    * **Normalization** before segmentation: the model's NormalizerSpec
      drives NFKC (any `*nfkc*` rule name; XLM-R ships `nmt_nfkc`) plus
      the NMT essentials (control chars dropped, zero-width marks
      dropped, all unicode whitespace -> ' '), `remove_extra_whitespaces`
      (collapse + strip), `add_dummy_prefix` and `escape_whitespaces`.
      The precompiled charsmap's few thousand extra codepoint rewrites
      are NOT reproduced (documented approximation — they cover corner
      codepoints NFKC already handles in the common cases).
    * **Piece types**: CONTROL/UNKNOWN/UNUSED pieces keep
      their ids but are EXCLUDED from the Viterbi vocabulary, so literal
      "<s>"/"</s>"/"<unk>" text in the input no longer segments to
      control ids (real spm does the same). BYTE pieces feed the
      byte-fallback table only. USER_DEFINED pieces stay matchable —
      spm segments user symbols from raw text.
    * **Byte fallback**: when the model carries `<0xXX>` BYTE pieces,
      an unknown character emits its UTF-8 bytes as those pieces (at
      their trained scores) instead of an unknown-char token.

    Segmentation is the standard Unigram Viterbi: maximize the sum of
    piece log-probs over the escaped text, per-character unknown
    fallback at UNK_PENALTY.
    """

    SPACE = "▁"            # ▁
    UNK_PENALTY = -100.0        # sentencepiece's unk_penalty default order
    # SentencePiece.Type enum values (sentencepiece_model.proto)
    NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

    def __init__(self, pieces, normalizer: Optional[dict] = None):
        """pieces: iterable of (piece, score) or (piece, score, type) in
        id order. A duplicated piece keeps its FIRST entry entirely (id
        AND score) — ids and segmentation probabilities must come from
        the same entry. `normalizer`: NormalizerSpec fields (see
        DEFAULT_NORMALIZER; XLM-R's nmt_nfkc defaults)."""
        self.vocab: dict = {}
        self.scores: dict = {}
        self.byte_pieces: dict = {}      # byte value -> (piece, score)
        for i, entry in enumerate(pieces):
            p, s, t = entry if len(entry) == 3 else (*entry, self.NORMAL)
            if p in self.vocab:
                continue
            self.vocab[p] = i
            if t == self.BYTE:
                # "<0xXX>" pieces: the byte-fallback alphabet
                try:
                    self.byte_pieces[int(p[1:-1], 16)] = (p, float(s))
                except ValueError:
                    pass
                continue
            if t in (self.CONTROL, self.UNKNOWN, self.UNUSED):
                continue                  # id-only: never segmentable
            self.scores[p] = float(s)
        self.max_len = max((len(p) for p in self.scores), default=1)
        self.normalizer = {**self.DEFAULT_NORMALIZER, **(normalizer or {})}

    DEFAULT_NORMALIZER = {
        "name": "nmt_nfkc",
        "add_dummy_prefix": True,
        "remove_extra_whitespaces": True,
        "escape_whitespaces": True,
    }

    # -- loading --------------------------------------------------------
    @staticmethod
    def _varint(buf: bytes, i: int):
        shift = val = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                return val, i
            shift += 7

    @classmethod
    def from_model_proto(cls, path: str) -> "SentencePieceUnigram":
        import struct

        with open(path, "rb") as f:
            buf = f.read()
        try:
            return cls(*cls._parse_pieces(buf, path))
        except (IndexError, struct.error) as e:
            # a truncated/corrupt .model cuts a varint or float field at
            # the buffer end — surface WHICH file is broken instead of a
            # raw parser traceback
            raise ValueError(
                f"{path}: truncated or corrupt sentencepiece model "
                f"(unexpected end of buffer while parsing: {e})") from e

    @classmethod
    def _parse_pieces(cls, buf: bytes, path: str):
        import struct

        pieces = []
        normalizer: dict = {}
        i, n = 0, len(buf)
        while i < n:
            tag, i = cls._varint(buf, i)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:          # ModelProto.pieces
                ln, i = cls._varint(buf, i)
                sub, j = buf[i: i + ln], 0
                i += ln
                piece, score, ptype = "", 0.0, cls.NORMAL
                while j < ln:
                    t2, j = cls._varint(sub, j)
                    f2, w2 = t2 >> 3, t2 & 7
                    if f2 == 1 and w2 == 2:       # piece
                        l2, j = cls._varint(sub, j)
                        piece = sub[j: j + l2].decode("utf-8", "replace")
                        j += l2
                    elif f2 == 2 and w2 == 5:     # score (float32)
                        score = struct.unpack("<f", sub[j: j + 4])[0]
                        j += 4
                    elif f2 == 3 and w2 == 0:     # type (enum varint)
                        ptype, j = cls._varint(sub, j)
                    elif w2 == 0:
                        _, j = cls._varint(sub, j)
                    elif w2 == 2:
                        l2, j = cls._varint(sub, j)
                        j += l2
                    elif w2 == 5:
                        j += 4
                    elif w2 == 1:
                        j += 8
                    else:
                        raise ValueError(f"bad wire type {w2} in {path}")
                pieces.append((piece, score, ptype))
            elif field == 3 and wire == 2:        # ModelProto.normalizer_spec
                ln, i = cls._varint(buf, i)
                normalizer = cls._parse_normalizer(buf[i: i + ln], path)
                i += ln
            elif wire == 0:
                _, i = cls._varint(buf, i)
            elif wire == 2:
                ln, i = cls._varint(buf, i)
                i += ln
            elif wire == 5:
                i += 4
            elif wire == 1:
                i += 8
            else:
                raise ValueError(f"bad wire type {wire} in {path}")
        if not pieces:
            raise ValueError(f"{path}: no sentencepiece pieces found")
        return pieces, normalizer

    @classmethod
    def _parse_normalizer(cls, sub: bytes, path: str) -> dict:
        """NormalizerSpec: name=1 (string), precompiled_charsmap=2
        (bytes, skipped — see class docstring), add_dummy_prefix=3,
        remove_extra_whitespaces=4, escape_whitespaces=5 (bool
        varints)."""
        spec: dict = {}
        bools = {3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
                 5: "escape_whitespaces"}
        j, ln = 0, len(sub)
        while j < ln:
            t2, j = cls._varint(sub, j)
            f2, w2 = t2 >> 3, t2 & 7
            if f2 == 1 and w2 == 2:
                l2, j = cls._varint(sub, j)
                spec["name"] = sub[j: j + l2].decode("utf-8", "replace")
                j += l2
            elif f2 in bools and w2 == 0:
                v, j = cls._varint(sub, j)
                spec[bools[f2]] = bool(v)
            elif w2 == 0:
                _, j = cls._varint(sub, j)
            elif w2 == 2:
                l2, j = cls._varint(sub, j)
                j += l2
            elif w2 == 5:
                j += 4
            elif w2 == 1:
                j += 8
            else:
                raise ValueError(f"bad wire type {w2} in {path}")
        return spec

    @classmethod
    def from_vocab_file(cls, path: str) -> "SentencePieceUnigram":
        pieces = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                score = float(parts[1]) if len(parts) > 1 else 0.0
                pieces.append((parts[0], score))
        return cls(pieces)

    # -- normalization ----------------------------------------------------
    _ZERO_WIDTH = frozenset(
        "\u200b\u200c\u200d\u200e\u200f\ufeff\u2060")

    def normalize(self, text: str) -> str:
        """NormalizerSpec essentials (see class docstring): NMT control/
        zero-width removal, NFKC, unicode-whitespace unification, extra-
        whitespace collapse + strip. `name == 'identity'` has an EMPTY
        precompiled charsmap in real spm, so it gets no whitespace
        unification — '\\t'/'\\n' pass through and segment as unknown
        chars/bytes; only the plain-' ' collapse/escape steps (which act
        on U+0020 alone) still apply."""
        spec = self.normalizer
        name = spec.get("name", "nmt_nfkc")
        if "nmt" in name:
            out = []
            for ch in text:
                o = ord(ch)
                if ch in self._ZERO_WIDTH:
                    continue
                if o == 0x7F or 0x80 <= o <= 0x9F or (
                        o < 0x20 and ch not in "\t\n\r\v\f"):
                    continue
                out.append(ch)
            text = "".join(out)
        if "nfkc" in name:
            text = unicodedata.normalize("NFKC", text)
        if name != "identity":
            # the nmt/nfkc-family charsmaps rewrite every whitespace
            # codepoint to ' '; identity's charsmap is empty
            text = "".join(" " if ch.isspace() else ch for ch in text)
        if spec.get("remove_extra_whitespaces", True):
            text = " ".join(p for p in text.split(" ") if p)
        return text

    # -- segmentation ---------------------------------------------------
    def encode(self, text: str):
        spec = self.normalizer
        s = self.normalize(text)
        if not s:
            # real spm returns [] for empty/whitespace-only input — the
            # dummy prefix is only added to non-empty normalized text
            return []
        if spec.get("add_dummy_prefix", True):
            s = " " + s
        if spec.get("escape_whitespaces", True):
            s = s.replace(" ", self.SPACE)
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            top = min(self.max_len, n - i)
            for ln in range(1, top + 1):
                piece = s[i: i + ln]
                sc = self.scores.get(piece)
                if sc is None:
                    if ln > 1:
                        continue
                    sc = self._fallback_score(piece)
                cand = best[i] + sc
                if cand > best[i + ln]:
                    best[i + ln] = cand
                    back[i + ln] = i
        out = []
        i = n
        while i > 0:
            j = back[i]
            seg = s[j:i]
            if (i - j == 1 and seg not in self.scores
                    and self.byte_pieces):
                bts = seg.encode("utf-8")
                if all(b in self.byte_pieces for b in bts):
                    # byte fallback: unknown char -> its UTF-8 bytes as
                    # <0xXX> pieces (real spm byte_fallback semantics)
                    out.extend(self.byte_pieces[b][0]
                               for b in reversed(bts))
                    i = j
                    continue
            out.append(seg)
            i = j
        return out[::-1]

    def _fallback_score(self, ch: str) -> float:
        bts = ch.encode("utf-8")
        if self.byte_pieces and all(b in self.byte_pieces for b in bts):
            return sum(self.byte_pieces[b][1] for b in bts)
        return self.UNK_PENALTY    # unknown char fallback


class XLMRobertaTokenizer(BaseTokenizer):
    """XLM-R sentencepiece tokenizer (reference tokenizers.py:340-420).

    Backends, in order:
      1. `sentencepiece` package (spm_model_path) — exact reference path;
      2. HF `tokenizers` (tokenizer_json_path);
      3. pure-Python Unigram (`SentencePieceUnigram`): parses the .model
         protobuf itself, or a plain `token<TAB>score` vocab
         (vocab_path), which needs no package.
    """

    def __init__(self, spm_model_path: Optional[str] = None,
                 tokenizer_json_path: Optional[str] = None,
                 special_tokens_path: Optional[str] = None,
                 vocab_path: Optional[str] = None):
        self.specials = load_special_tokens(special_tokens_path)
        self.unk = self.specials["unk_token"]
        self.backend = None
        if spm_model_path:
            try:
                import sentencepiece as spm

                self.sp = spm.SentencePieceProcessor()
                self.sp.Load(spm_model_path)
                self.backend = "spm"
                self.vocab = {self.sp.IdToPiece(i): i
                              for i in range(self.sp.GetPieceSize())}
            except ImportError:
                pass
        if self.backend is None and tokenizer_json_path:
            try:
                from tokenizers import Tokenizer as HFTokenizer

                self.hf = HFTokenizer.from_file(tokenizer_json_path)
                self.backend = "hf"
                self.vocab = self.hf.get_vocab()
            except ImportError:
                pass
        if self.backend is None and spm_model_path:
            self.uni = SentencePieceUnigram.from_model_proto(spm_model_path)
            self.backend = "unigram"
            self.vocab = dict(self.uni.vocab)
        if self.backend is None and vocab_path:
            self.uni = SentencePieceUnigram.from_vocab_file(vocab_path)
            self.backend = "unigram"
            self.vocab = dict(self.uni.vocab)
        if self.backend is None:
            raise RuntimeError(
                "XLMRobertaTokenizer needs an .spm model (sentencepiece "
                "package or the built-in protobuf parser), a tokenizer.json "
                "(HF tokenizers), or a plain token<TAB>score vocab file")
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

    def tokenize(self, text, use_vocab=True):
        if self.backend == "spm":
            return self.sp.EncodeAsPieces(text)
        if self.backend == "unigram":
            return self.uni.encode(text)
        return self.hf.encode(text, add_special_tokens=False).tokens

    def convert_tokens_to_ids(self, tokens):
        if self.backend == "spm":
            return [self.sp.PieceToId(t) for t in tokens]
        unk_id = self.vocab.get(self.unk, 0)
        return [self.vocab.get(t, unk_id) for t in tokens]


class VirtualTokenizer(BaseTokenizer):
    """Empty-vocab tokenizer for vision models (tokenizers.py:590-596)."""

    def __init__(self, *a, **kw):
        super().__init__(None, None)

    def tokenize(self, text, use_vocab=True):
        return []


class ImageTokenizer(BaseTokenizer):
    """VQGAN image tokenizer (tokenizers.py:583-589) over the port's VQModel
    encode path (towers/vqgan.py), with the vocabulary <img_0> ...
    <img_{n_embed-1}>. `vqgan_model_path` (a taming checkpoint) gives real
    tokens; without it the encoder's weights come from `seed`. It encodes
    on `device`, the GPU unless the caller names another."""

    def __init__(self, *a, vqgan_model_path: Optional[str] = None,
                 vqgan_config: Optional[dict] = None, seed: int = 0,
                 device=None, **kw):
        from lr2ppo_torch.towers.vqgan import VQGANConfig, make_image_tokenizer

        super().__init__(None, None)
        cfg = VQGANConfig(**(vqgan_config or {}))
        self._tokenize_pixels, self.cfg = make_image_tokenizer(
            cfg, vqgan_model_path, seed, device)
        self.vocab = {f"<img_{i}>": i for i in range(cfg.n_embed)}
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

    def tokenize_images(self, pixels01) -> np.ndarray:
        """(B, C, H, W) floats in [0, 1] -> (B, N) int32 codebook ids."""
        return self._tokenize_pixels(pixels01)

    def tokenize(self, text, use_vocab=True):
        raise TypeError("ImageTokenizer tokenizes images, not text; "
                        "use tokenize_images(pixels)")


class TextImageTokenizer(BertTokenizer):
    """Text tokenizer + image vocab offset (tokenizers.py:597-604)."""

    def __init__(self, vocab_path=None, special_tokens_path=None,
                 image_vocab_size: int = 8192, **kw):
        super().__init__(vocab_path, special_tokens_path, **kw)
        self.image_vocab_size = image_vocab_size


str2tokenizer = {
    "char": CharTokenizer,
    "space": SpaceTokenizer,
    "bert": BertTokenizer,
    "bpe": BPETokenizer,
    "xlmroberta": XLMRobertaTokenizer,
    "virtual": VirtualTokenizer,
    "image": ImageTokenizer,
    "text_image": TextImageTokenizer,
}
