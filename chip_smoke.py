#!/usr/bin/env python3
"""Chip smoke of zgml_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name, power limit), build the CUDA kernels
     from zgml_tpu_torch/csrc with nvcc (one process per source, in
     parallel), print the build time;
  2. check each kernel against its plain torch version on the card at the
     TinyLlama-1.1B shapes of the main paths, and time both (device time from
     torch.profiler), at Q4_0 and at Q8_0 where the kernel takes a weight:
     K2 at M = 1 and 128 on the five projections; K1 at M = 1, 8, 32 (its
     quantized activations bit-equal to the plain ones); K5 on lm_head (its
     id equal to argmax of K1 exactly; its error is how far the plain logit
     of its id lies below the plain maximum); K6 at M = 1, 8, 32 (K6d at
     Q4_0, K6a at Q8_0); K7 at pos 0, 1, 200, 2047 of a random stacked cache;
     K3 and K4. Each case also gets its bound (the least time the card could
     take: bytes moved, each input read once and each output written once,
     over 3.35 TB/s, or f32 operations over 67 TFLOP/s, whichever is larger;
     the __dp4a kernels K1 and K5 take the bytes bound) and, where one
     PyTorch call computes the same function, that call's device time
     (library_ms, timed here and used nowhere in the port);
  3. end to end: synthetic TinyLlama-1.1B GGUFs at Q4_0 and Q8_0 (written to
     .bench_cache/ once, from seed 0) -> load_llama(device="cuda") ->
     LlamaEngine(prefill_chunk=128), on three paths, each with the placement
     counts set to 0 just before it and read just after:
       default     Q4_0, the JAX package's default flags: 3 greedy requests
                   (prompts of 7, 128 and 300 tokens, 32 tokens each, reset
                   between) and 1 sampled request (temperature 0.8, the
                   engine's seeded generator); K1q4, K2q4, K3, K5q4, K6d and
                   K7 must launch;
       unfused     Q4_0, ZGML_TPU_ATTN_BLOCK=0 ZGML_TPU_KERNELS_DISABLE=fused_ffn
                   ZGML_TPU_I8DOT=0 (the port's first slice): the 3 greedy
                   requests; K2q4, K3 and K4 must launch;
       q8_default  Q8_0, the default flags: the 3 greedy and the sampled
                   request; K1q8, K2q8, K3, K5q8, K6a and K7 (Q8_0) must
                   launch;
     no other kernel and no plain-tier call may run on a path; on each path
     the first request is compared with the same engine under force_ref()
     (the same path with every kernel swapped for its plain version);
  4. prefill (pp128) and decode (tg32) tokens/s of every path, measured in
     turns (rounds of default, unfused, q8_default, q8_default, unfused,
     default; median per path), and per path a torch.profiler breakdown of
     one prefill chunk and 8 decode steps;
  5. print the kernels' JSON line, then the device JSON line last.
Details also go to chiprun_out/chip_smoke/ (summary JSON, profiler tables).
There is no CPU path: without a CUDA device it exits 2.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"
SEED = 0
# Weight std of the synthetic models. At 0.05 (the JAX package's synthetic
# default) the random 22-layer stack turns the ~1e-6 f32 differences between
# kernel and plain path into bf16 K/V-cache rounding flips worth ~1.3e-3 of
# max|logit| (measured on the H100); with an f32 cache the same perturbation
# stays at ~4e-6, so that is cache rounding amplified by random weights, not
# kernel error. At 0.01 the flips cost ~2.6e-4 (CPU experiment, PERF.md).
WEIGHT_STD = 0.01

# (name, N, K) of every projection of the TinyLlama-1.1B layer and the head
GEMM_SHAPES = [("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w_gate_up", 11264, 2048),
               ("w_down", 2048, 5632), ("lm_head", 32000, 2048)]
L, HQ, HKV, D, S = 22, 32, 4, 64, 2048
FFN_D, FFN_F = 2048, 5632
# (q_offset, kv_len) of the flash checks: first chunk, second chunk, a
# kv_len that ends inside the chunk; and decode kv_len values
FLASH_CASES = [(0, 128), (128, 256), (128, 200)]
DECODE_LENS = [1, 200, 2047]
LOGIT_RTOL = 1e-3          # K2 and K3 run f32 operands
I8_ROWS = (1, 8, 32)       # K1 cases: decode, a small batch, the largest int8 call
ATTN_POS = (0, 1, 200, 2047)
FFN_ROWS = (1, 8, 32)      # K6: decode, and calls of <= 32 rows outside it
GREEDY_TRIALS = 8
RATE_ROUNDS = 5            # phase 4: rounds of the paths in turns, there and back
ATTN_LAYER = 3             # K7 reads and writes a layer slab other than the first
REL_BOUND = 1e-5           # K1, K6, K7 vs plain: f32 sums in another order
PROFILE_TRIES = 3
KINDS = ("q4_0", "q8_0")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit) for the bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the JAX flags of each path (config.py); a missing key is unset, i.e. default
PATHS = {"default": {},
         "unfused": {"ZGML_TPU_ATTN_BLOCK": "0", "ZGML_TPU_KERNELS_DISABLE": "fused_ffn",
                     "ZGML_TPU_I8DOT": "0"},
         "q8_default": {}}
PATH_KIND = {"default": "q4_0", "unfused": "q4_0", "q8_default": "q8_0"}
PATH_SAMPLED = ("default", "q8_default")      # paths that also answer the sampled request
PATH_KERNELS = {"default": ("q4_matmul_i8", "q4_matmul", "flash_attention", "q4_greedy",
                            "fused_ffn_norm", "attn_block"),
                "unfused": ("q4_matmul", "flash_attention", "decode_attention"),
                "q8_default": ("q8_matmul_i8", "q8_matmul", "flash_attention", "q8_greedy",
                               "fused_ffn_norm_q8", "attn_block_q8")}
_CSRC = "zgml_tpu_torch/csrc/"
# kernel -> (placement counter of ops/dispatch.py, source, TPU kernel it replaces)
KERNELS = {
    "q4_matmul": ("qmatmul", _CSRC + "qmatmul.cu", "zgml_tpu/ops/qmatmul.py:141"),
    "flash_attention": ("attention", _CSRC + "flash_attn.cu", "zgml_tpu/ops/attention.py:194"),
    "decode_attention": ("decode_attention", _CSRC + "decode_attn.cu",
                         "zgml_tpu/ops/attention.py:375"),
    "q4_matmul_i8": ("qmatmul_i8", _CSRC + "qmatmul_i8.cu", "zgml_tpu/ops/qmatmul.py:306"),
    "q4_greedy": ("qmatmul_greedy", _CSRC + "qmatmul_i8.cu", "zgml_tpu/ops/qmatmul.py:462"),
    "fused_ffn_norm": ("fused_ffn_norm", _CSRC + "ffn.cu", "zgml_tpu/ops/ffn.py:459"),
    "attn_block": ("attn_block", _CSRC + "layer_attn.cu", "zgml_tpu/ops/layerkernel.py:685"),
    "q8_matmul": ("qmatmul_q8", _CSRC + "qmatmul.cu", "zgml_tpu/ops/qmatmul.py:81"),
    "q8_matmul_i8": ("qmatmul_i8_q8", _CSRC + "qmatmul_i8.cu", "zgml_tpu/ops/qmatmul.py:233"),
    "q8_greedy": ("qmatmul_greedy_q8", _CSRC + "qmatmul_i8.cu", "zgml_tpu/ops/qmatmul.py:444"),
    "fused_ffn_norm_q8": ("fused_ffn_norm_q8", _CSRC + "ffn.cu", "zgml_tpu/ops/ffn.py:100"),
    "attn_block_q8": ("attn_block_q8", _CSRC + "layer_attn.cu",
                      "zgml_tpu/ops/layerkernel.py:685"),
}
# kernel name of each (kernel family, kind) checked in phase 2
NAME = {("matmul", "q4_0"): "q4_matmul", ("matmul", "q8_0"): "q8_matmul",
        ("i8", "q4_0"): "q4_matmul_i8", ("i8", "q8_0"): "q8_matmul_i8",
        ("greedy", "q4_0"): "q4_greedy", ("greedy", "q8_0"): "q8_greedy",
        ("ffn", "q4_0"): "fused_ffn_norm", ("ffn", "q8_0"): "fused_ffn_norm_q8",
        ("attn", "q4_0"): "attn_block", ("attn", "q8_0"): "attn_block_q8"}
# why a kernel has no library_ms
NO_LIBRARY = {
    "q8": "none: no PyTorch call computes a 32-block Q8_0 product (torch._weight_int8pack_mm "
          "takes one scale per output channel, not per 32-block)",
    "greedy": "none: no single PyTorch call computes the quantized GEMV and its argmax",
    "ffn": "none: no single PyTorch call computes rmsnorm + quantized gate|up + SwiGLU + down "
           "+ residual",
    "attn": "none: no single PyTorch call computes the fused attention half-layer "
            "(rmsnorm, quantized QKV, RoPE, attention, wo, residual, cache write)",
}


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, calls, iters: int) -> tuple[float, float]:
    """(device ms, host-inclusive ms) per call over `iters` calls, cycling
    through `calls` (several weight copies keep the L2 cache cold, as in a
    real step). Device ms is the sum of the calls' kernel durations from
    torch.profiler (CUPTI); host-inclusive ms is CUDA-event time over the
    loop, which includes the Python wrapper when it is slower than the
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for c in calls:
        c()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    host_ms = start.elapsed_time(end) / iters
    # after many profiler sessions in one process a window now and then comes
    # back without its device events (seen on the H100); the calls are
    # idempotent, so the window is profiled again
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        dev_us = sum(_self_device_us(ev) for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA)
        if dev_us > 0:
            return dev_us / 1e3 / iters, host_ms
    raise RuntimeError(f"the profiler saw no kernel in {PROFILE_TRIES} windows")


def _self_device_us(ev) -> float:
    v = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if v is None else v


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def bound_of(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and do `flops` f32 operations."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(torch, dev):
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_ref,
                                              flash_attention_cuda, flash_attention_ref)
    from zgml_tpu_torch.ops.ffn import fused_ffn_norm_cuda, fused_ffn_norm_ref
    from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ref
    from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, greedy_ref, qmatmul_cuda,
                                            qmatmul_i8_cuda, qmatmul_i8_ref, qmatmul_ref,
                                            quantize_act_cuda, quantize_act_ref)
    from zgml_tpu_torch.quant.packed import PackedWeight

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {name: [] for name in KERNELS}

    def record(kernel, case, err, bound, t, tp, nbytes, flops, lib=None, lib_note=None):
        """One case: error, device times, the bound from this case's bytes
        and operations (flops 0: the bytes bound alone), and the library
        call's time or why there is none."""
        b_ms, b_by = bound_of(nbytes, flops)
        lib_ms = None if lib is None else lib[0]
        results[kernel].append(dict(case=case, err=err, bound=bound, ms=t[0], call_ms=t[1],
                                    plain_ms=tp[0], plain_call_ms=tp[1], bytes=nbytes,
                                    flops=flops, bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms, library_note=lib_note))
        lib_txt = (f"library {lib_ms * 1e3:.1f}" if lib_ms is not None
                   else f"library {lib_note.split(':')[0]}")
        log(f"  {kernel} {case}: max_abs_err {err:.3g} (bound {bound:.3g}); device us "
            f"kernel {t[0] * 1e3:.1f} plain {tp[0] * 1e3:.1f} {lib_txt}; bound "
            f"{b_ms * 1e3:.1f} us by {b_by} ({100 * b_ms / t[0]:.0f}% of the kernel's time); "
            f"per call incl. host kernel {t[1] * 1e3:.1f} plain {tp[1] * 1e3:.1f}")

    def weights(kind, n, k, total_bytes=128_000_000):
        """Copies of a random [n, k] weight of `kind` totalling >=
        total_bytes, so cycling through them finds the 50 MB L2 cold, as in
        a real step."""
        per = n * k // 2 if kind == "q4_0" else n * k
        nbytes = per + n * k // 16
        out = []
        for _ in range(max(2, -(-total_bytes // nbytes))):
            d = (torch.rand((n, k // 32), device=dev, generator=g) * 0.02 + 0.001).half()
            if kind == "q4_0":
                qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=dev,
                                   generator=g)
            else:
                qs = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev,
                                   generator=g)
                d = d / 16
            out.append(PackedWeight(n, k, qs, d, kind))
        return out

    def rel_err(got, want):
        err = float((got - want).abs().max())
        bound = REL_BOUND * float(want.abs().max())
        return err, bound

    def int4pack(copies):
        """The Q4_0 weights as torch._weight_int4pack_mm operands (tinygemm:
        value = (q - 8) * scale + zero, group size 32, zero 0, bf16 scales),
        or the reason the installed torch refuses them."""
        try:
            out = []
            for w in copies:
                nib = (w.levels() + 8).to(torch.uint8).reshape(w.n, w.k)
                w4 = torch._convert_weight_to_int4pack((nib[:, ::2] << 4) | nib[:, 1::2], 8)
                sz = torch.stack([w.d.T.to(torch.bfloat16),
                                  torch.zeros_like(w.d.T, dtype=torch.bfloat16)], -1)
                out.append((w4, sz.contiguous()))
            return out, None
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            return None, f"none: torch._weight_int4pack_mm refused ({type(e).__name__}: {e})"

    def time_int4(packs, x, want):
        """((device ms, host ms) of the int4pack call, note) with its error
        against the plain f32 result (bf16 activations and scales), or (None,
        why not)."""
        xb = x.to(torch.bfloat16)
        try:
            y = torch._weight_int4pack_mm(xb, packs[0][0], 32, packs[0][1]).float()
        except (RuntimeError, NotImplementedError) as e:
            return None, f"none: torch._weight_int4pack_mm refused ({type(e).__name__}: {e})"
        torch.cuda.synchronize()
        err = float((y - want).abs().max()) / float(want.abs().max())
        if err > 0.05:       # not the same function: bf16 rounding stays near 1e-2
            return None, f"none: torch._weight_int4pack_mm gave rel err {err:.2g} here"
        t = time_ms(torch, [lambda p_=p: torch._weight_int4pack_mm(xb, p_[0], 32, p_[1])
                            for p in packs], 50)
        return t, (f"torch._weight_int4pack_mm, bf16 activations and scales (rel err "
                   f"{err:.2g} vs the f32 plain output)")

    for kind in KINDS:
        for name, n, k in GEMM_SHAPES:
            copies = weights(kind, n, k)
            w = copies[0]
            wbytes = nbytes_of(w.qs, w.d)
            packs, refusal = int4pack(copies) if kind == "q4_0" else (None, None)
            for m in (1, 128):
                x = torch.randn((m, k), device=dev, generator=g)
                got, want = qmatmul_cuda(x, w), qmatmul_ref(x, w)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                bound = 1e-4 * k ** 0.5 + 1e-5 * float(want.abs().max())
                kname = NAME["matmul", kind]
                require(bool(torch.isfinite(got).all()) and err <= bound,
                        f"{kname} {name} M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
                t = time_ms(torch, [lambda w_=c: qmatmul_cuda(x, w_) for c in copies], 50)
                tp = time_ms(torch, [lambda w_=c: qmatmul_ref(x, w_) for c in copies], 20)
                lib, note = None, NO_LIBRARY["q8"] if kind == "q8_0" else refusal
                if packs is not None:
                    lib, note = time_int4(packs, x, want)
                record(kname, f"{name} M={m} N={n} K={k}", err, bound, t, tp,
                       m * k * 4 + wbytes + m * n * 4, 2 * m * n * k, lib, note)
            for m in I8_ROWS:
                x = torch.randn((m, k), device=dev, generator=g)
                xq, xs = quantize_act_cuda(x)
                rq, rs = quantize_act_ref(x)
                got, want = qmatmul_i8_cuda(x, w), qmatmul_i8_ref(x, w)
                torch.cuda.synchronize()
                kname = NAME["i8", kind]
                require(torch.equal(xq, rq)
                        and torch.equal(xs.view(torch.int32), rs.view(torch.int32)),
                        f"{kname} {name} M={m}: quantized activations differ from plain")
                err, bound = rel_err(got, want)
                require(bool(torch.isfinite(got).all()) and err <= bound,
                        f"{kname} {name} M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
                t = time_ms(torch, [lambda w_=c: qmatmul_i8_cuda(x, w_) for c in copies], 50)
                tp = time_ms(torch, [lambda w_=c: qmatmul_i8_ref(x, w_) for c in copies], 10)
                lib, note = None, NO_LIBRARY["q8"] if kind == "q8_0" else refusal
                if packs is not None:
                    lib, note = time_int4(packs, x, qmatmul_ref(x, w))
                record(kname, f"{name} M={m} N={n} K={k}", err, bound, t, tp,
                       m * k * 4 + wbytes + m * n * 4, 0, lib, note)
            if name == "lm_head":
                check_greedy(torch, dev, g, kind, copies, record, greedy_cuda, greedy_ref,
                             qmatmul_i8_cuda, qmatmul_i8_ref)
            del copies, w, packs

        # K6 at the FFN shapes: M = 1 (decode) and the larger calls of <= 32 rows
        d, f = FFN_D, FFN_F
        gus, wds = weights(kind, 2 * f, d, 96_000_000), weights(kind, d, f, 48_000_000)
        pairs = list(zip(gus, wds))
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        kname = NAME["ffn", kind]
        for m in FFN_ROWS:
            x = torch.randn((1, m, d), device=dev, generator=g)
            got = fused_ffn_norm_cuda(x, gamma, gus[0], wds[0], 1e-5)
            want = fused_ffn_norm_ref(x, gamma, gus[0], wds[0], 1e-5)
            torch.cuda.synchronize()
            err, bound = rel_err(got, want)
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{kname} M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
            t = time_ms(torch, [lambda p_=pr: fused_ffn_norm_cuda(x, gamma, p_[0], p_[1], 1e-5)
                                for pr in pairs], 50 if m == 1 else 10)
            tp = time_ms(torch, [lambda p_=pr: fused_ffn_norm_ref(x, gamma, p_[0], p_[1], 1e-5)
                                 for pr in pairs], 20 if m == 1 else 10)
            record(kname, f"M={m} D={d} F={f}", err, bound, t, tp,
                   2 * m * d * 4 + d * 4 + nbytes_of(gus[0].qs, gus[0].d, wds[0].qs, wds[0].d),
                   2 * m * 3 * d * f, None, NO_LIBRARY["ffn"])
        del gus, wds, pairs
        check_attn_block(torch, dev, g, kind, weights, rel_err, record, refs, attn_block_cuda,
                         attn_block_ref)

    check_attention(torch, dev, g, record, flash_attention_cuda, flash_attention_ref,
                    decode_attention_cuda, decode_attention_ref)
    return results


def check_greedy(torch, dev, g, kind, copies, record, greedy_cuda, greedy_ref,
                 qmatmul_i8_cuda, qmatmul_i8_ref):
    """K5 on lm_head. It returns an id, so its error is measured in logits:
    how far the plain logit of the kernel's id lies below the plain maximum."""
    w = copies[0]
    kname = NAME["greedy", kind]
    lost, off_k1, off_plain, compared = [], 0, 0, 0
    for _ in range(GREEDY_TRIALS):
        x = torch.randn((1, w.k), device=dev, generator=g)
        tok = int(greedy_cuda(x, w)[0])
        y = qmatmul_i8_cuda(x, w)[0]
        y_ref = qmatmul_i8_ref(x, w)[0]
        tok_ref = int(greedy_ref(x, w)[0])
        torch.cuda.synchronize()
        off_k1 += tok != int(torch.argmax(y))
        bound = REL_BOUND * float(y_ref.abs().max())
        lost.append((float(y_ref.max() - y_ref[tok]), bound))
        top = y_ref.topk(2).values
        if float(top[0] - top[1]) > bound:
            compared += 1
            off_plain += tok != tok_ref
    require(off_k1 == 0, f"{kname}: {off_k1} of {GREEDY_TRIALS} ids != argmax(K1)")
    require(off_plain == 0,
            f"{kname}: {off_plain} of {compared} ids != plain (top-2 gap over bound)")
    require(all(e <= b for e, b in lost),
            f"{kname}: (max(plain) - plain[id], bound) per row {lost}")
    err, bound = max(lost, key=lambda eb: eb[0] / eb[1])
    t = time_ms(torch, [lambda w_=c: greedy_cuda(x, w_) for c in copies], 50)
    tp = time_ms(torch, [lambda w_=c: greedy_ref(x, w_) for c in copies], 10)
    record(kname, f"lm_head N={w.n} K={w.k}, {GREEDY_TRIALS} rows: ids != argmax(K1) "
           f"{off_k1}/{GREEDY_TRIALS}, != plain id {off_plain}/{compared} (rows whose "
           f"plain top-2 gap exceeds the bound); error = max(plain) - plain[id]",
           err, bound, t, tp, w.k * 4 + nbytes_of(w.qs, w.d) + 8, 0, None,
           NO_LIBRARY["greedy"])


def check_attn_block(torch, dev, g, kind, weights, rel_err, record, refs, attn_block_cuda,
                     attn_block_ref):
    """K7 over a random stacked cache, layer ATTN_LAYER."""
    kc = torch.randn((L, 1, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((L, 1, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    d, nq, nkv = HQ * D, HQ * D, HKV * D
    nqkv = nq + 2 * nkv
    wqkvs, wos = weights(kind, nqkv, d, 64_000_000), weights(kind, d, nq, 64_000_000)
    layers = list(zip(wqkvs, wos))
    wbytes = nbytes_of(wqkvs[0].qs, wqkvs[0].d, wos[0].qs, wos[0].d)
    gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    kname = NAME["attn", kind]
    for pos in ATTN_POS:
        x = torch.randn((1, 1, d), device=dev, generator=g)
        cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=dev), D)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
        kr, vr = kc.clone(), vc.clone()
        got = attn_block_cuda(x, gamma, wqkvs[0], wos[0], kc, vc, ATTN_LAYER, pos_t, cos, sin,
                              HQ, HKV, 1e-5)
        want = attn_block_ref(x, gamma, wqkvs[0], wos[0], kr, vr, ATTN_LAYER, pos, cos, sin,
                              HQ, HKV, 1e-5)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        require(all(bool(torch.isfinite(a).all()) for a in got)
                and all(e <= b for e, b in errs),
                f"{kname} pos={pos}: (max_abs_err, bound) of x_out, k_cur, v_cur {errs}")
        rows = torch.arange(S, device=dev) != pos
        require(torch.equal(kc[ATTN_LAYER, 0, :, pos], got[1][0, :, 0].to(torch.bfloat16))
                and torch.equal(vc[ATTN_LAYER, 0, :, pos], got[2][0, :, 0].to(torch.bfloat16))
                and torch.equal(kc[..., rows, :], kr[..., rows, :])
                and torch.equal(vc[..., rows, :], vr[..., rows, :]),
                f"{kname} pos={pos}: cache row pos is not bf16(k_cur, v_cur), or another "
                f"row changed")
        t = time_ms(torch, [lambda l_=ly: attn_block_cuda(x, gamma, l_[0], l_[1], kc, vc,
                                                          ATTN_LAYER, pos_t, cos, sin, HQ,
                                                          HKV, 1e-5) for ly in layers], 50)
        tp = time_ms(torch, [lambda l_=ly: attn_block_ref(x, gamma, l_[0], l_[1], kc, vc,
                                                          ATTN_LAYER, pos, cos, sin, HQ,
                                                          HKV, 1e-5) for ly in layers], 20)
        worst = max(errs, key=lambda eb: eb[0] / eb[1])
        # x, gamma, the weights, cos/sin and the pos cache rows in; x_out,
        # k_cur/v_cur and the new bf16 cache row out
        nbytes = (2 * d * 4 + wbytes + D * 4 + 2 * pos * nkv * 2
                  + d * 4 + 2 * nkv * 4 + 2 * nkv * 2)
        flops = 2 * d * nqkv + 2 * nq * d + 4 * HQ * (pos + 1) * D
        record(kname, f"pos={pos} layer={ATTN_LAYER} (x_out, k_cur, v_cur)",
               worst[0], worst[1], t, tp, nbytes, flops, None, NO_LIBRARY["attn"])
    del wqkvs, wos, layers


def check_attention(torch, dev, g, record, flash_attention_cuda, flash_attention_ref,
                    decode_attention_cuda, decode_attention_ref):
    """K3 and K4 over a random stacked cache; the library call is
    scaled_dot_product_attention with enable_gqa over the same cache rows,
    cast to f32 outside the timed window."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc = torch.randn((L, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((L, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    for q_off, kv_len in FLASH_CASES:
        q = torch.randn((1, HQ, 128, D), device=dev, generator=g)
        row = (q_off // 128) % L
        got = flash_attention_cuda(q, kc, vc, kv_len, q_off, row)
        want = flash_attention_ref(q, kc, vc, kv_len, q_off, row)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= 1e-5,
                f"flash_attention q_offset={q_off} kv_len={kv_len}: max_abs_err {err:.3g}")
        t = time_ms(torch, [lambda: flash_attention_cuda(q, kc, vc, kv_len, q_off, row)], 50)
        tp = time_ms(torch, [lambda: flash_attention_ref(q, kc, vc, kv_len, q_off, row)], 20)
        kf = kc[row:row + 1, :, :kv_len].float()
        vf = vc[row:row + 1, :, :kv_len].float()
        qi = torch.arange(128, device=dev)[:, None] + q_off
        mask = torch.arange(kv_len, device=dev)[None, :] <= qi
        lib_err = float((sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True) - want).abs().max())
        lib = time_ms(torch, [lambda: sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True)], 50)
        live = int(mask.sum())                         # (query, key) pairs attended
        record("flash_attention", f"Tq=128 q_offset={q_off} kv_len={kv_len}", err, 1e-5, t, tp,
               2 * q.numel() * 4 + 2 * kv_len * HKV * D * 2, 4 * HQ * live * D, lib,
               f"scaled_dot_product_attention(enable_gqa=True, boolean causal mask), f32 "
               f"(max abs err {lib_err:.2g})")

    for kv_len in DECODE_LENS:
        q = torch.randn((1, HQ, 1, D), device=dev, generator=g)
        lens = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        row = kv_len % L
        got = decode_attention_cuda(q, kc, vc, lens, row)
        want = decode_attention_ref(q, kc, vc, lens, row)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= 1e-5,
                f"decode_attention kv_len={kv_len}: max_abs_err {err:.3g}")
        t = time_ms(torch, [lambda: decode_attention_cuda(q, kc, vc, lens, row)], 100)
        tp = time_ms(torch, [lambda: decode_attention_ref(q, kc, vc, lens, row)], 20)
        kf = kc[row:row + 1, :, :kv_len].float()
        vf = vc[row:row + 1, :, :kv_len].float()
        lib_err = float((sdpa(q, kf, vf, enable_gqa=True) - want).abs().max())
        lib = time_ms(torch, [lambda: sdpa(q, kf, vf, enable_gqa=True)], 100)
        record("decode_attention", f"kv_len={kv_len}", err, 1e-5, t, tp,
               2 * q.numel() * 4 + 2 * kv_len * HKV * D * 2, 4 * HQ * kv_len * D, lib,
               f"scaled_dot_product_attention(enable_gqa=True), one query, f32 "
               f"(max abs err {lib_err:.2g})")


def model_path(kind: str) -> pathlib.Path:
    from zgml_tpu_torch.io.gguf import GGMLType
    from zgml_tpu_torch.utils.synthetic import TINYLLAMA_1_1B, write_synthetic_llama_gguf
    path = ROOT / ".bench_cache" / f"tinyllama-1.1b-{kind}-seed{SEED}-std{WEIGHT_STD}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_synthetic_llama_gguf(str(path), TINYLLAMA_1_1B, quant=GGMLType[kind.upper()],
                                   seed=SEED, scale=WEIGHT_STD)
        log(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        log(f"  reusing {path.name}")
    return path


def top2_gap(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def set_path(name: str):
    """Set the JAX flags of a path in this process (the port reads them at
    call time)."""
    for flags in PATHS.values():
        for k in flags:
            os.environ.pop(k, None)
    os.environ.update(PATHS[name])


def load_model(torch, dev, kind: str):
    from zgml_tpu_torch.io.llama_loader import load_llama
    path = model_path(kind)
    t0 = time.perf_counter()
    model, gf = load_llama(str(path), device=dev)
    gf.close()
    torch.cuda.synchronize()
    require(all(ly[w].kind == kind for ly in model.params["layers"]
                for w in ("wqkv", "wo", "w_gate_up", "w_down"))
            and model.params["lm_head"].kind == kind,
            f"{path.name}: the loaded weights are not all {kind}")
    log(f"  loaded {kind} in {time.perf_counter() - t0:.1f} s: {model.cfg}")
    return model


def end_to_end(torch, model, prompts, name, summary):
    """Drive one path through the engine; returns (engine, launches)."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.sampling import SamplingParams

    set_path(name)
    eng = LlamaEngine(model, prefill_chunk=128)
    sampled = (LlamaEngine(model, prefill_chunk=128, sampling=SamplingParams(temperature=0.8))
               if name in PATH_SAMPLED else None)
    vocab = model.cfg.vocab_size

    torch.cuda.synchronize()
    global_profile.reset()
    outs = []
    for p in prompts:
        eng.reset()
        outs.append(eng.generate(p, 32))
    if sampled is not None:
        outs.append(sampled.generate(prompts[0], 32))
    torch.cuda.synchronize()
    tiers = global_profile.tier_summary()
    launches = {k: tiers.get(counter, {}).get("cuda", 0) for k, (counter, _, _) in KERNELS.items()}
    plain = {op: t["ref"] for op, t in tiers.items() if t.get("ref")}
    log(f"  [{name}] {len(outs)} requests answered; placement: {tiers}")
    require(all(launches[k] > 0 for k in PATH_KERNELS[name]),
            f"[{name}] a kernel of the path never launched: {launches}")
    require(all(n == 0 for k, n in launches.items() if k not in PATH_KERNELS[name]),
            f"[{name}] a kernel of another path launched: {launches}")
    require(not plain, f"[{name}] plain tier ran on the main path: {plain}")
    for i, out in enumerate(outs):
        require(len(out) == 32 and all(0 <= t < vocab for t in out),
                f"[{name}] request {i} gave {out}")
        prompt, kind = (prompts[0], "sampled T=0.8") if i == 3 else (prompts[i], "greedy")
        log(f"  [{name}] prompt {len(prompt):>3} tokens, {kind} -> {out}")
    del sampled

    # the first request against the plain versions of the same path on the card
    eng.reset()
    logits_k = eng.prefill(prompts[0])
    with force_ref():
        eng.reset()
        logits_r = eng.prefill(prompts[0])
        tok = torch.argmax(logits_r, dim=-1)
        ref_toks, gaps = [int(tok[0])], [top2_gap(logits_r[0])]
        for _ in range(31):
            tok, lg = eng.step(tok)
            ref_toks.append(int(tok[0]))
            gaps.append(top2_gap(lg[0]))
    torch.cuda.synchronize()
    require(tuple(logits_k.shape) == (1, vocab) and bool(torch.isfinite(logits_k).all()),
            f"[{name}] prefill logits {tuple(logits_k.shape)} not finite [1, {vocab}]")
    bound = LOGIT_RTOL * float(logits_r.abs().max())
    err = float((logits_k - logits_r).abs().max())
    require(err <= bound, f"[{name}] prefill logits: max_abs_err {err:.4g} > bound {bound:.4g}")
    n_cmp = next((i for i, gap in enumerate(gaps) if gap < bound), 32)
    require(outs[0][:n_cmp] == ref_toks[:n_cmp],
            f"[{name}] tokens differ before step {n_cmp}: {outs[0]} vs plain {ref_toks}")
    log(f"  [{name}] request 1 vs force_ref(): logits max_abs_err {err:.4g} (bound {bound:.4g}); "
        f"tokens equal over the first {n_cmp} of 32 steps"
        + ("" if n_cmp == 32 else f" (plain top-2 gap {gaps[n_cmp]:.3g} < bound at step {n_cmp})")
        + f"; all 32 equal: {outs[0] == ref_toks}")
    summary.setdefault("e2e", {})[name] = dict(
        flags=PATHS[name], weights=PATH_KIND[name], launches=launches, placement=tiers,
        logits_err=err, logits_bound=bound, tokens_checked=n_cmp,
        tokens_all_equal=outs[0] == ref_toks, min_gap=min(gaps), outputs=outs)
    return eng, launches


def rates(torch, engines, prompt, card, summary):
    """pp128 and tg32 of every path, measured in turns: RATE_ROUNDS rounds of
    the paths there and back (default, unfused, q8_default, q8_default,
    unfused, default), one prefill and one 32-token decode_n per turn, so an
    order effect on the host falls on every path alike; the median per path."""
    p128 = prompt[:128]
    runs = {name: ([], []) for name in engines}
    order = list(engines) + list(engines)[::-1]
    for _ in range(RATE_ROUNDS):
        for name in order:
            set_path(name)
            eng = engines[name]
            eng.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = eng.prefill(p128)
            torch.cuda.synchronize()
            runs[name][0].append(time.perf_counter() - t0)
            tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.decode_n(tok, 32)
            torch.cuda.synchronize()
            runs[name][1].append(time.perf_counter() - t0)
    for name, (pp, tg) in runs.items():
        pp_s, tg_s = statistics.median(pp), statistics.median(tg)
        log(f"  [{name}] pp128: {128 / pp_s:.1f} tok/s ({pp_s * 1e3:.2f} ms per 128-token "
            f"chunk; fastest turn {128 / min(pp):.1f})  [{card}]")
        log(f"  [{name}] tg32:  {32 / tg_s:.1f} tok/s ({tg_s / 32 * 1e3:.3f} ms per token; "
            f"fastest turn {32 / min(tg):.1f})  [{card}]")
        summary.setdefault("rates", {})[name] = dict(
            pp128_tok_s=128 / pp_s, tg32_tok_s=32 / tg_s, pp128_runs_s=pp, tg32_runs_s=tg,
            order=order, rounds=RATE_ROUNDS, card=card)


def profile(torch, eng, prompt, name, summary):
    """Device time by kernel of one 128-token prefill chunk and of 8 decode
    steps (torch.profiler over CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    out = {}
    for label in ("prefill128", "decode8"):
        for _ in range(PROFILE_TRIES):     # see time_ms: a window may come back empty
            eng.reset()
            if label == "decode8":
                tok = torch.argmax(eng.prefill(prompt[:128]), dim=-1)
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if label == "prefill128":
                    eng.prefill(prompt[:128])
                else:
                    eng.decode_n(tok, 8)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = []
            for ev in prof.key_averages():     # device-side events only: the kernels
                if ev.device_type != DeviceType.CUDA:
                    continue
                rows.append((ev.key, _self_device_us(ev), ev.count))
            if rows:
                break
        require(bool(rows), f"[{name}] {label}: the profiler saw no kernel")
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[label] = dict(wall_us=wall * 1e6, device_busy_us=busy,
                          kernels=[dict(name=k[:90], us=u, count=c) for k, u, c in rows[:15]])
        log(f"  [{name}] {label}: host wall {wall * 1e3:.2f} ms, device busy "
            f"{busy / 1e3:.2f} ms ({100 * busy / (wall * 1e6):.1f}%)")
        for k, u, c in rows[:8]:
            log(f"    {u / 1e3:8.3f} ms  x{c:<5} {k[:80]}")
    summary.setdefault("profile", {})[name] = out


def kernel_line(name, cases, by_path) -> dict:
    """One kernel of the JSON line: sums over its phase-2 cases; bound_by is
    the bound that carries more of the summed bound; library_ms is summed
    where every case has a library call, else null (library_note says why)."""
    _, src, replaces = KERNELS[name]
    by_bytes = sum(c["bound_ms"] for c in cases if c["bound_by"] == "bytes")
    by_ops = sum(c["bound_ms"] for c in cases if c["bound_by"] == "operations")
    libs = [c["library_ms"] for c in cases]
    has_lib = all(v is not None for v in libs)
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=max(c["err"] for c in cases),
                ms=sum(c["ms"] for c in cases),
                plain_ms=sum(c["plain_ms"] for c in cases),
                bound_ms=by_bytes + by_ops,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=sum(libs) if has_lib else None,
                library_note=cases[0]["library_note"] if not has_lib else
                "; ".join(sorted({c["library_note"].split(" (")[0] for c in cases})),
                cases=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here", file=sys.stderr)
        return 2
    from zgml_tpu_torch.ops import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {}

    log("== 1. card and build")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    path, nvcc_s = build.build()
    build.library()
    log(f"  kernels built in {nvcc_s:.1f} s (load {time.perf_counter() - t0:.1f} s): {path}")

    log("== 2. kernels vs plain torch on the card (TinyLlama-1.1B shapes, Q4_0 and Q8_0)")
    checks = check_kernels(torch, dev)

    log("== 3. end to end: TinyLlama-1.1B, the default and unfused paths at Q4_0, the "
        "default path at Q8_0")
    models = {kind: load_model(torch, dev, kind) for kind in KINDS}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, models["q4_0"].cfg.vocab_size, n) for n in (7, 128, 300)]
    engines, launches = {}, {}
    for name in PATHS:
        engines[name], launches[name] = end_to_end(torch, models[PATH_KIND[name]], prompts,
                                                   name, summary)

    log("== 4. rates (the paths in turns) and where the time goes")
    rates(torch, engines, prompts[2], card, summary)
    for name, eng in engines.items():
        set_path(name)
        profile(torch, eng, prompts[2], name, summary)

    kernels = [kernel_line(name, checks[name], {p: launches[p][name] for p in PATHS})
               for name in KERNELS]
    summary.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=nvcc_s, kernels=kernels)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
