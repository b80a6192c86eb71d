"""The port's BPE tokenizer (zgml_tpu_torch/io/tokenizer.py) against the JAX
package's on the same inputs: the cases of tests/test_io_extra.py:142-205
(a tiny vocabulary's round trip, the GPT-2 pre-tokenizer against the
canonical pattern, whose `regex` module is the golden oracle, and a fuzz),
the repo's BPE (tests/data/bpe) on text and on the corpus the repo encoded
with it, and a tokenizer read from a GGUF whose token list is padded to the
model's vocabulary (utils/synthetic.tokenizer_metadata). Ids and text must
be equal: the two are the same algorithm, exact in every step.
"""
import dataclasses
import os
import random

import numpy as np
import pytest
import regex

from zgml_tpu.io.gguf import GGUFFile as JaxGGUFFile
from zgml_tpu.io.llama_loader import config_from_gguf as jax_config_from_gguf
from zgml_tpu.io.tokenizer import BPETokenizer as JaxBPETokenizer

from zgml_tpu_torch.io.gguf import GGMLType, GGUFFile
from zgml_tpu_torch.io.llama_loader import config_from_gguf
from zgml_tpu_torch.io.tokenizer import BPETokenizer, _bytes_to_unicode
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf

DATA = os.path.join(os.path.dirname(__file__), "data")
BPE = (os.path.join(DATA, "bpe", "vocab.json"), os.path.join(DATA, "bpe", "merges.txt"))
GPT2_PATTERN = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
GOLDEN = [
    "Hello world",
    "I'm sure they're won't we've y'all'll i'd 'S 'x",
    "  leading and   multiple   spaces  ",
    "tabs\tand\nnewlines \t mixed\r\n end",
    "numbers 123 mixed42text 3.14 1,000,000",
    "punct!!! ...---... #hashtag @user (parens) [brackets]",
    "unicode: café naïve Ångström 北京 русский مرحبا",
    "roman numerals Ⅷ Ⅻ and fractions ½ ¾",
    "emoji 🙂🙂 and symbols €100 £50 ¥",
    "trailing space ",
    " ",
    "\n\n\n",
    "a",
    "don't stop believin' — hold on to that feelin'",
    "CamelCase and snake_case and kebab-case",
    "x y nbsp  double",
]
TEXTS = GOLDEN + ["The port runs the quantized llama path on the card: prefill, decode, "
                  "the int8 KV cache and the fused FFN.\n\n    def forward(self, x):\n"]


def test_tiny_vocab_roundtrip_matches_jax():
    b2u = _bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(b2u.values())}
    vocab["he"] = len(vocab)
    vocab["hel"] = len(vocab)
    merges = [("h", "e"), ("he", "l")]
    tok, jtok = BPETokenizer(vocab, merges), JaxBPETokenizer(vocab, merges)
    ids = tok.encode("hello world")
    assert ids == jtok.encode("hello world")
    assert tok.decode(ids) == jtok.decode(ids) == "hello world"
    assert vocab["hel"] in ids


@pytest.mark.parametrize("text", GOLDEN)
def test_pretokenizer_matches_gpt2_regex_and_jax(text):
    tok = BPETokenizer.__new__(BPETokenizer)      # the pre-tokenizer needs no vocabulary
    got = tok._split_pretok(text)
    assert got == GPT2_PATTERN.findall(text) == JaxBPETokenizer.__new__(
        JaxBPETokenizer)._split_pretok(text)
    assert "".join(got) == text


def test_pretokenizer_fuzz_vs_regex_and_jax():
    tok = BPETokenizer.__new__(BPETokenizer)
    jtok = JaxBPETokenizer.__new__(JaxBPETokenizer)
    rng = random.Random(0)
    alphabet = ("abcXYZ019' \t\n.,-—Ⅷ½北водé🙂  "
                + "".join(chr(c) for c in range(0x20, 0x7f, 7)))
    for _ in range(300):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randrange(0, 40)))
        assert tok._split_pretok(text) == GPT2_PATTERN.findall(text) == \
            jtok._split_pretok(text), repr(text)


@pytest.mark.parametrize("text", TEXTS)
def test_repo_bpe_ids_and_text_match_jax(text):
    tok, jtok = BPETokenizer.from_files(*BPE), JaxBPETokenizer.from_files(*BPE)
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids)


def test_corpus_decodes_and_reencodes_as_jax():
    """The repo's corpus (tools/make_corpus.py encoded it with this BPE):
    decoded to text it re-encodes to the same ids in both packages."""
    toks = np.load(os.path.join(DATA, "corpus_tokens.npy"))[:4096].tolist()
    tok, jtok = BPETokenizer.from_files(*BPE), JaxBPETokenizer.from_files(*BPE)
    text = tok.decode(toks)
    assert text == jtok.decode(toks)
    assert tok.encode(text) == jtok.encode(text)


def test_from_gguf_on_a_padded_token_list_matches_jax(tmp_path):
    """A GGUF carrying the repo's 4122-token BPE in a 4608-row model: the
    list is padded to the model's vocabulary, so both packages read
    vocab_size 4608; both build the same tokenizer from it, and no id of an
    encoding lands on a placeholder."""
    cfg = dataclasses.replace(TINY_TEST, vocab_size=4608)
    path = str(tmp_path / "tok.gguf")
    write_synthetic_llama_gguf(path, cfg, GGMLType.Q8_0, seed=2,
                               tokenizer=BPETokenizer.from_files(*BPE))
    with GGUFFile(path) as gf:
        assert config_from_gguf(gf).vocab_size == cfg.vocab_size
        tok = BPETokenizer.from_gguf(gf)
    with JaxGGUFFile(path) as jgf:
        assert jax_config_from_gguf(jgf).vocab_size == cfg.vocab_size
        jtok = JaxBPETokenizer.from_gguf(jgf)
    assert tok.special_tokens == jtok.special_tokens == {"<s>": 4122, "</s>": 4123}
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) == BPETokenizer.from_files(*BPE).encode(text)
        assert max(ids, default=0) < 4122
        assert tok.decode(ids) == jtok.decode(ids)
