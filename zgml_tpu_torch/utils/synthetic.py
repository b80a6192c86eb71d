"""Synthetic llama-architecture GGUF files with real model shapes.

Counterpart of zgml_tpu/utils/synthetic.py (same presets and tensor names).
Nothing is downloaded: weights are random, from a numpy seed. Q4_0 and Q8_0
matmul weights are written as random valid blocks directly (levels uniform
on -7..7 or -127..127, per-block fp16 scales matched to the std), which
writes the TinyLlama-1.1B shape in seconds where quantizing f32 draws would
take minutes; other types are quantized from f32 normal draws. A map from
tensor name to type writes a file that mixes kinds, as real GGUFs do (e.g.
attn_v at Q8_0 inside a Q4_0 model), and a tokenizer can be embedded.
"""
from __future__ import annotations

import os

import numpy as np

from zgml_tpu_torch.io.gguf import GGMLType, GGUFWriter
from zgml_tpu_torch.models.llama import LlamaConfig
from zgml_tpu_torch.quant.blocks import QK, Q4_0_BLOCK_BYTES, Q8_0_BLOCK_BYTES

SMOLLM_135M = LlamaConfig(vocab_size=49152, d_model=576, n_heads=9, n_kv_heads=3,
                          d_ff=1536, n_layers=30, max_seq_len=2048,
                          rope_base=10000.0, tied_lm_head=True)
TINYLLAMA_1_1B = LlamaConfig(vocab_size=32000, d_model=2048, n_heads=32,
                             n_kv_heads=4, d_ff=5632, n_layers=22,
                             max_seq_len=2048, rope_base=10000.0)
LLAMA2_7B = LlamaConfig(vocab_size=32000, d_model=4096, n_heads=32, n_kv_heads=32,
                        d_ff=11008, n_layers=32, max_seq_len=4096,
                        rope_base=10000.0)
LLAMA3_8B = LlamaConfig(vocab_size=128256, d_model=4096, n_heads=32, n_kv_heads=8,
                        d_ff=14336, n_layers=32, max_seq_len=8192,
                        rope_base=500000.0)
TINY_TEST = LlamaConfig(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=128, n_layers=2, max_seq_len=64)

_LEVEL_STD = float(np.sqrt(2 * sum(i * i for i in range(1, 8)) / 15))  # std of -7..7
_Q8_LEVEL_STD = float(np.sqrt(127 * 128 / 3))                          # std of -127..127


def random_q4_0_blocks(rng: np.random.Generator, n: int, k: int, std: float) -> np.ndarray:
    """Raw Q4_0 bytes of a random [n, k] weight whose values have roughly
    standard deviation `std`."""
    nb = n * k // QK
    nib = rng.integers(1, 16, size=(nb, QK), dtype=np.uint8)
    d = (std / _LEVEL_STD * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    blk = np.empty((nb, Q4_0_BLOCK_BYTES), np.uint8)
    blk[:, :2] = d.view(np.uint8).reshape(nb, 2)
    blk[:, 2:] = nib[:, :16] | (nib[:, 16:] << 4)
    return blk.reshape(-1)


def random_q8_0_blocks(rng: np.random.Generator, n: int, k: int, std: float) -> np.ndarray:
    """Raw Q8_0 bytes of a random [n, k] weight whose values have roughly
    standard deviation `std`."""
    nb = n * k // QK
    q = rng.integers(-127, 128, size=(nb, QK), dtype=np.int8)
    d = (std / _Q8_LEVEL_STD * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    blk = np.empty((nb, Q8_0_BLOCK_BYTES), np.uint8)
    blk[:, :2] = d.view(np.uint8).reshape(nb, 2)
    blk[:, 2:] = q.view(np.uint8)
    return blk.reshape(-1)


_RANDOM_BLOCKS = {GGMLType.Q4_0: random_q4_0_blocks, GGMLType.Q8_0: random_q8_0_blocks}


def tokenizer_metadata(tokenizer, vocab_size: int) -> dict:
    """The tokenizer.ggml.* keys of a BPETokenizer (io/tokenizer.py) in a
    model of `vocab_size` rows. config_from_gguf reads the vocabulary size
    from the token list, so the list is padded to vocab_size with unique
    placeholders that no merge produces (their first character is outside
    the byte-level alphabet); the first two placeholders are BOS and EOS."""
    tokens = [None] * len(tokenizer.vocab)
    for tok, i in tokenizer.vocab.items():
        tokens[i] = tok
    if None in tokens or vocab_size < len(tokens) + 2:
        raise ValueError(f"a tokenizer of {len(tokens)} dense ids needs at least two ids of "
                         f"room in a vocabulary of {vocab_size}")
    bos = len(tokens)
    tokens += [f"\ue000{i}" for i in range(len(tokens), vocab_size)]
    return {"tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.merges": tokenizer.merges(),
            "tokenizer.ggml.bos_token_id": bos, "tokenizer.ggml.eos_token_id": bos + 1}


def write_synthetic_llama_gguf(path: str, cfg: LlamaConfig,
                               quant: int = GGMLType.Q4_0, seed: int = 0,
                               scale: float = 0.05, kinds: dict[str, int] | None = None,
                               tokenizer=None):
    """Write a random llama GGUF with llama.cpp tensor names and metadata.
    `kinds` maps a matmul tensor's name (e.g. "blk.0.attn_v.weight",
    "output.weight") to the type it is written in instead of `quant`;
    `tokenizer` (a BPETokenizer) embeds its vocabulary (tokenizer_metadata).
    Without either the bytes are those of earlier versions. The file appears
    at `path` only once complete."""
    kinds = kinds or {}
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    w = GGUFWriter()
    w.add_metadata("general.architecture", "llama")
    w.add_metadata("general.name", "synthetic")
    w.add_metadata("llama.embedding_length", cfg.d_model)
    w.add_metadata("llama.block_count", cfg.n_layers)
    w.add_metadata("llama.attention.head_count", cfg.n_heads)
    w.add_metadata("llama.attention.head_count_kv", cfg.n_kv_heads)
    w.add_metadata("llama.feed_forward_length", cfg.d_ff)
    w.add_metadata("llama.context_length", cfg.max_seq_len)
    w.add_metadata("llama.rope.freq_base", cfg.rope_base)
    w.add_metadata("llama.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps)
    if tokenizer is not None:
        for key, value in tokenizer_metadata(tokenizer, cfg.vocab_size).items():
            w.add_metadata(key, value)

    def rand(*shape):
        out = rng.standard_normal(shape, dtype=np.float32)
        out *= scale
        return out

    def matmul(name, n, k):
        t = kinds.get(name, quant)
        if t in _RANDOM_BLOCKS:
            w.add_raw_tensor(name, (n, k), t, _RANDOM_BLOCKS[t](rng, n, k, scale))
        else:
            w.add_tensor(name, rand(n, k), t)

    w.add_tensor("token_embd.weight", rand(cfg.vocab_size, d), GGMLType.F32)
    w.add_tensor("output_norm.weight", np.ones(d, np.float32), GGMLType.F32)
    if not cfg.tied_lm_head:
        matmul("output.weight", cfg.vocab_size, d)
    for i in range(cfg.n_layers):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(d, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(d, np.float32))
        matmul(f"blk.{i}.attn_q.weight", nq, d)
        matmul(f"blk.{i}.attn_k.weight", nkv, d)
        matmul(f"blk.{i}.attn_v.weight", nkv, d)
        matmul(f"blk.{i}.attn_output.weight", d, nq)
        matmul(f"blk.{i}.ffn_gate.weight", cfg.d_ff, d)
        matmul(f"blk.{i}.ffn_up.weight", cfg.d_ff, d)
        matmul(f"blk.{i}.ffn_down.weight", d, cfg.d_ff)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        w.write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
