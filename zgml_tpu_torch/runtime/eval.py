"""Perplexity: the quality of a model's next-token distribution on text.

Counterpart of zgml_tpu/runtime/eval.py (:25-75), in llama.cpp's windowed
form: the token stream is split into `window`-token chunks, each scored with
a fresh context. The difference in perplexity between two weight formats
(dense against Q8_0 or Q4_0) or two caches (bf16 against int8) on the same
tokens is the measure of what quantization costs; it does not depend on the
dataset.

Each window is one forward of its window + 1 tokens at position 0 into a
fresh cache of `cache_dtype` ("bf16" or "int8"), with logits for every row:
the model's prefill path, so on the card K2 (or torch.matmul for a dense
model's projections) and K3 over the bf16 cache, K9 over the int8 one. The
NLL is the teacher-forced sum of -log softmax (f32) at each next token.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from zgml_tpu_torch.runtime.profile import global_profile


@torch.inference_mode()
def window_nll(model, tokens, cache_dtype: str = "bf16") -> tuple[float, int]:
    """Sum of the NLL (nats) over one [T] window scored with its whole
    context, and the number of targets T - 1."""
    with global_profile.phase("eval_window"):
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=model.device)[None]
        cache = model.init_cache(1, cache_dtype)
        logits = model(toks, cache, 0)
        logp = torch.log_softmax(logits[0, :-1].to(torch.float32), dim=-1)
        nll = -logp.gather(-1, toks[0, 1:, None])[:, 0].sum()
        return float(nll), int(toks.shape[1] - 1)


def perplexity(model, tokens, window: int = 256, cache_dtype: str = "bf16") -> float:
    """exp(mean NLL) over non-overlapping windows. Each forwards window + 1
    tokens (the targets are shifted), so a window takes at most
    max_seq_len - 1 positions; the last one may be shorter."""
    tokens = np.asarray(tokens)
    total, count = 0.0, 0
    window = min(window, model.cfg.max_seq_len - 1)
    for i in range(0, len(tokens) - 1, window):
        chunk = tokens[i:i + window + 1]
        if len(chunk) < 2:
            break
        nll, n = window_nll(model, chunk, cache_dtype)
        total += nll
        count += n
    return math.exp(total / max(1, count))


def ppl_delta(model_a, model_b, tokens, window: int = 256, cache_dtype_a: str = "bf16",
              cache_dtype_b: str = "bf16") -> tuple[float, float, float]:
    """(ppl_a, ppl_b, |ppl_a - ppl_b|) on the same tokens; cache_dtype_b
    "int8" measures the int8 cache's cost on one model."""
    pa = perplexity(model_a, tokens, window, cache_dtype_a)
    pb = perplexity(model_b, tokens, window, cache_dtype_b)
    return pa, pb, abs(pa - pb)
