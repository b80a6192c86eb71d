"""Workspace of the cooperative kernels (K6d csrc/ffn.cu, K7 csrc/layer_attn.cu).

Their grid barrier (csrc/common.cuh grid_barrier) spins on two uint32 words
that start at 0 and that every launch leaves at (0, generation). Launches on
one stream run one after another, so they can share the words; launches on
two streams could run at once and must not. The words are therefore kept per
(device, stream), allocated zeroed on first use.
"""
from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_words: dict[tuple[int, int], torch.Tensor] = {}


def barrier_words(device: torch.device) -> torch.Tensor:
    """Two barrier words (int32 [2]) for a launch on the current stream of
    `device`."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    with _lock:
        ws = _words.get(key)
        if ws is None:
            ws = torch.zeros(2, dtype=torch.int32, device=torch.device("cuda", idx))
            _words[key] = ws
    return ws
