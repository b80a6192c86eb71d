"""Workspace of the cooperative kernels (K6 csrc/ffn.cu, K6b csrc/ffn_planar.cu,
K7 csrc/layer_attn.cu, K14 / K15 csrc/stack_decode.cu) and of K4's merge
(csrc/decode_attn.cu).

The weight-streaming kernels' grid barrier (csrc/weight_stream.cuh
CountBarrier) takes words 2-4 of the barrier words, two arrival counts and an
epoch, which start at 0 and which each launch leaves ready for the next one
on its stream (words 0-1 are unused). The counter words count arrivals (K7's
and the megacalls' phase B a KV head, K4's splits a row and KV head) and each
launch leaves them zeroed. Launches on one stream run one after another, so
they can share the words; launches on two streams could run at once and must
not. The words are therefore kept per (device, stream), allocated zeroed on
first use.
"""
from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_words: dict[tuple[int, int], torch.Tensor] = {}


def barrier_words(device: torch.device) -> torch.Tensor:
    """The barrier words (int32 [8]; CountBarrier's three from word 2) for a
    launch on the current stream of `device`."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    with _lock:
        ws = _words.get(key)
        if ws is None:
            ws = torch.zeros(8, dtype=torch.int32, device=torch.device("cuda", idx))
            _words[key] = ws
    return ws


_counters: dict[tuple[int, int], torch.Tensor] = {}


def counter_words(device: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed uint32 words (int32) for a launch on the current
    stream of `device` that counts arrivals in them and leaves them zeroed
    (K7 and the megacalls: one a KV head; K4: one a batch row and KV head),
    kept per (device, stream) as the barrier words."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    with _lock:
        ws = _counters.get(key)
        if ws is None or ws.numel() < n:
            ws = torch.zeros(max(n, 64), dtype=torch.int32, device=torch.device("cuda", idx))
            _counters[key] = ws
    return ws


_scratch: dict[tuple[int, int], torch.Tensor] = {}


def scratch(device: torch.device, nbytes: int) -> torch.Tensor:
    """At least nbytes of uint8 scratch (256-byte aligned, contents
    undefined) for a launch on the current stream of `device` that writes it
    before it reads it (K1 / K5's global int8 activations and K5's per-block
    maxima), kept per (device, stream) and grown as needed, as the words."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    with _lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                              device=torch.device("cuda", idx))
            _scratch[key] = buf
    return buf
