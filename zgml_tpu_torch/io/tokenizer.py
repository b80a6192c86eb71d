"""GPT-2 byte-level BPE tokenizer.

Counterpart of zgml_tpu/io/tokenizer.py (the same algorithm, so both packages
give the same ids and text): the HF file pair (vocab.json + merges.txt) or
the vocabulary a GGUF carries (tokenizer.ggml.tokens / .merges / .bos_token_id
/ .eos_token_id). The GPT-2 pre-tokenizer is a scanner with the semantics of
the canonical pattern, so nothing outside the standard library is needed.
"""
from __future__ import annotations

import json
import os
import unicodedata


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte<->unicode mapping: printable bytes map to themselves, the rest to
    256+ codepoints."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
         list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


class BPETokenizer:
    """Byte-level BPE with iterative lowest-rank merge."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: dict[str, int] | None = None):
        self.vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.special_tokens = special_tokens or {}
        for tok, tid in self.special_tokens.items():
            self.decoder.setdefault(tid, tok)
        self._cache: dict[str, list[str]] = {}

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_path: str | os.PathLike, merges_path: str | os.PathLike):
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_gguf(cls, gf) -> "BPETokenizer":
        """Build from GGUF metadata (llama.cpp convention)."""
        tokens = gf.metadata.get("tokenizer.ggml.tokens")
        if tokens is None:
            raise ValueError("GGUF has no embedded tokenizer")
        vocab = {t: i for i, t in enumerate(tokens)}
        merges_raw = gf.metadata.get("tokenizer.ggml.merges", [])
        merges = []
        for m in merges_raw:
            a, _, b = m.partition(" ")
            merges.append((a, b))
        special = {}
        for key, name in (("tokenizer.ggml.bos_token_id", "<s>"),
                          ("tokenizer.ggml.eos_token_id", "</s>")):
            if key in gf.metadata:
                special[name] = int(gf.metadata[key])
        return cls(vocab, merges, special)

    def merges(self) -> list[str]:
        """The merges in rank order, as "a b" strings (tokenizer.ggml.merges)."""
        return [f"{a} {b}" for (a, b), _ in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])]

    # -- BPE ----------------------------------------------------------------
    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            best, best_rank = None, None
            for i in range(len(word) - 1):
                r = self.bpe_ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            word[best:best + 2] = [word[best] + word[best + 1]]
        self._cache[token] = word
        return word

    def _split_pretok(self, text: str) -> list[str]:
        """GPT-2 pre-tokenizer, exact semantics of the canonical pattern
        's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
        implemented as a manual scanner (no `regex` dependency at runtime;
        golden-tested against the real pattern in tests/test_torch_tokenizer.py).
        \\p{L} is Unicode category L* (NOT str.isalpha, which also accepts
        letter-numbers like Roman numerals), \\p{N} is category N*; the
        trailing-whitespace rule leaves the last space to attach to the next
        word (byte-exact vs HF / llama.cpp)."""
        cat = unicodedata.category
        is_l = lambda ch: cat(ch).startswith("L")       # noqa: E731
        is_n = lambda ch: cat(ch).startswith("N")       # noqa: E731
        out: list[str] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch == "'":                               # contractions
                if text.startswith(("'re", "'ve", "'ll"), i):
                    out.append(text[i:i + 3])
                    i += 3
                    continue
                if i + 1 < n and text[i + 1] in "stmd":
                    out.append(text[i:i + 2])
                    i += 2
                    continue
            sp = 1 if (ch == " " and i + 1 < n) else 0
            j = i + sp
            if j < n and is_l(text[j]):                 # ` ?\p{L}+`
                k = j + 1
                while k < n and is_l(text[k]):
                    k += 1
                out.append(text[i:k])
                i = k
                continue
            if j < n and is_n(text[j]):                 # ` ?\p{N}+`
                k = j + 1
                while k < n and is_n(text[k]):
                    k += 1
                out.append(text[i:k])
                i = k
                continue
            if j < n and not text[j].isspace():         # ` ?[^\s\p{L}\p{N}]+`
                k = j + 1
                while k < n and not (text[k].isspace() or is_l(text[k])
                                     or is_n(text[k])):
                    k += 1
                out.append(text[i:k])
                i = k
                continue
            # whitespace: `\s+(?!\S)` (all, or all-but-last) else `\s+`
            k = i
            while k < n and text[k].isspace():
                k += 1
            if k == n or k - i == 1:
                out.append(text[i:k])
                i = k
            else:
                out.append(text[i:k - 1])
                i = k - 1
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._split_pretok(text):
            mapped = "".join(_BYTE_ENCODER[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                tid = self.vocab.get(sub)
                if tid is None:
                    # fall back to per-character encoding
                    for ch in sub:
                        cid = self.vocab.get(ch)
                        if cid is not None:
                            ids.append(cid)
                else:
                    ids.append(tid)
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        data = bytes(_BYTE_DECODER.get(ch, ord("?") & 0xFF) if ch in _BYTE_DECODER
                     else 0x3F for ch in text)
        return data.decode("utf-8", errors="replace")
