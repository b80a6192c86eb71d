#!/usr/bin/env python3
"""Chip smoke of zgml_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name, power limit), build the CUDA kernels
     from zgml_tpu_torch/csrc with nvcc (one process per source, in
     parallel), print the build time;
  2. check each kernel against its plain torch version on the card at the
     TinyLlama-1.1B shapes of the main path, and time both (device time from
     torch.profiler): K2, K3, K4 (the unfused path); K1 at M = 1, 8, 32 on the
     five projections (its quantized activations bit-equal to the plain
     ones), K5 on lm_head (its id equal to argmax of K1 exactly; its error
     is how far the plain logit of its id lies below the plain maximum),
     K6d at M = 1, 8, 32 (decode, and the calls of <= 32 rows outside the
     fused decode), and K7 at pos 0, 1, 200, 2047 of a random stacked cache;
  3. end to end: a synthetic TinyLlama-1.1B Q4_0 GGUF (written to
     .bench_cache/ once, from seed 0) -> load_llama(device="cuda") ->
     LlamaEngine(prefill_chunk=128), on two paths, each with the placement
     counts set to 0 just before it and read just after:
       default  the JAX package's default flags: 3 greedy requests (prompts
                of 7, 128 and 300 tokens, 32 tokens each, reset between) and
                1 sampled request (temperature 0.8, the engine's seeded
                generator); K1, K2, K3, K5, K6d and K7 must launch;
       unfused  ZGML_TPU_ATTN_BLOCK=0 ZGML_TPU_KERNELS_DISABLE=fused_ffn
                ZGML_TPU_I8DOT=0 (the port's first slice): the 3 greedy requests; K2,
                K3 and K4 must launch;
     no plain-tier call may run on either; on each path the first request
     is compared with the same engine under force_ref() (the same path with
     every kernel swapped for its plain version);
  4. prefill (pp128) and decode (tg32) tokens/s of both paths, measured in
     turns (rounds of default, unfused, unfused, default; median per path),
     and per path a torch.profiler breakdown of one prefill chunk and 8
     decode steps;
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
# Weight std of the synthetic model. At 0.05 (the JAX package's synthetic
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
# (q_offset, kv_len) of the flash checks: first chunk, second chunk, a
# kv_len that ends inside the chunk; and decode kv_len values
FLASH_CASES = [(0, 128), (128, 256), (128, 200)]
DECODE_LENS = [1, 200, 2047]
LOGIT_RTOL = 1e-3          # K2 and K3 run f32 operands
I8_ROWS = (1, 8, 32)       # K1 cases: decode, a small batch, the largest int8 call
ATTN_POS = (0, 1, 200, 2047)
FFN_ROWS = (1, 8, 32)      # K6d: decode, and calls of <= 32 rows outside it
GREEDY_TRIALS = 8
RATE_ROUNDS = 5            # phase 4: rounds of (default, unfused, unfused, default)
ATTN_LAYER = 3             # K7 reads and writes a layer slab other than the first
REL_BOUND = 1e-5           # K1, K6d, K7 vs plain: f32 sums in another order
PROFILE_TRIES = 3
# the JAX flags of each path (config.py); a missing key is unset, i.e. default
PATHS = {"default": {},
         "unfused": {"ZGML_TPU_ATTN_BLOCK": "0", "ZGML_TPU_KERNELS_DISABLE": "fused_ffn",
                 "ZGML_TPU_I8DOT": "0"}}
PATH_KERNELS = {"default": ("q4_matmul_i8", "q4_matmul", "flash_attention", "q4_greedy",
                            "fused_ffn_norm", "attn_block"),
                "unfused": ("q4_matmul", "flash_attention", "decode_attention")}
# kernel -> (placement counter of ops/dispatch.py, source, TPU kernel it replaces)
KERNELS = {
    "q4_matmul": ("qmatmul", "zgml_tpu_torch/csrc/q4_matmul.cu", "zgml_tpu/ops/qmatmul.py:141"),
    "flash_attention": ("attention", "zgml_tpu_torch/csrc/flash_attn.cu",
                        "zgml_tpu/ops/attention.py:194"),
    "decode_attention": ("decode_attention", "zgml_tpu_torch/csrc/decode_attn.cu",
                         "zgml_tpu/ops/attention.py:375"),
    "q4_matmul_i8": ("qmatmul_i8", "zgml_tpu_torch/csrc/q4_i8_matmul.cu",
                     "zgml_tpu/ops/qmatmul.py:306"),
    "q4_greedy": ("qmatmul_greedy", "zgml_tpu_torch/csrc/q4_i8_matmul.cu",
                  "zgml_tpu/ops/qmatmul.py:462"),
    "fused_ffn_norm": ("fused_ffn_norm", "zgml_tpu_torch/csrc/ffn.cu", "zgml_tpu/ops/ffn.py:459"),
    "attn_block": ("attn_block", "zgml_tpu_torch/csrc/layer_attn.cu",
                   "zgml_tpu/ops/layerkernel.py:685"),
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


def check_kernels(torch, dev):
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_ref,
                                              flash_attention_cuda, flash_attention_ref)
    from zgml_tpu_torch.ops.ffn import fused_ffn_norm_cuda, fused_ffn_norm_ref
    from zgml_tpu_torch.ops.layerkernel import attn_block_cuda, attn_block_ref
    from zgml_tpu_torch.ops.qmatmul import (q4_greedy_cuda, q4_greedy_ref, q4_matmul_cuda,
                                            q4_matmul_i8_cuda, q4_matmul_i8_ref, q4_matmul_ref,
                                            quantize_act_cuda, quantize_act_ref)
    from zgml_tpu_torch.quant.packed import PackedWeight

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {name: [] for name in KERNELS}

    def record(kernel, case, err, bound, t, tp):
        results[kernel].append(dict(case=case, err=err, bound=bound, ms=t[0], call_ms=t[1],
                                    plain_ms=tp[0], plain_call_ms=tp[1]))
        log(f"  {kernel} {case}: max_abs_err {err:.3g} (bound {bound:.3g}); device us "
            f"kernel {t[0] * 1e3:.1f} plain {tp[0] * 1e3:.1f}; per call incl. host "
            f"kernel {t[1] * 1e3:.1f} plain {tp[1] * 1e3:.1f}")

    def weights(n, k, total_bytes=128_000_000):
        """Copies of a random Q4_0 [n, k] weight totalling >= total_bytes, so
        cycling through them finds the 50 MB L2 cold, as in a real step."""
        nbytes = n * k // 2 + n * k // 16
        return [PackedWeight(n, k, torch.randint(0, 256, (n, k // 2), dtype=torch.uint8,
                                                 device=dev, generator=g),
                             (torch.rand((n, k // 32), device=dev, generator=g) * 0.02
                              + 0.001).half())
                for _ in range(max(2, -(-total_bytes // nbytes)))]

    def rel_err(got, want):
        err = float((got - want).abs().max())
        bound = REL_BOUND * float(want.abs().max())
        return err, bound

    for name, n, k in GEMM_SHAPES:
        copies = weights(n, k)
        w = copies[0]
        for m in (1, 128):
            x = torch.randn((m, k), device=dev, generator=g)
            got, want = q4_matmul_cuda(x, w), q4_matmul_ref(x, w)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bound = 1e-4 * k ** 0.5 + 1e-5 * float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"q4_matmul {name} M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
            t = time_ms(torch, [lambda w_=c: q4_matmul_cuda(x, w_) for c in copies], 50)
            tp = time_ms(torch, [lambda w_=c: q4_matmul_ref(x, w_) for c in copies], 20)
            record("q4_matmul", f"{name} M={m} N={n} K={k}", err, bound, t, tp)
        for m in I8_ROWS:
            x = torch.randn((m, k), device=dev, generator=g)
            xq, xs = quantize_act_cuda(x)
            rq, rs = quantize_act_ref(x)
            got, want = q4_matmul_i8_cuda(x, w), q4_matmul_i8_ref(x, w)
            torch.cuda.synchronize()
            require(torch.equal(xq, rq) and torch.equal(xs.view(torch.int32), rs.view(torch.int32)),
                    f"q4_matmul_i8 {name} M={m}: quantized activations differ from plain")
            err, bound = rel_err(got, want)
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"q4_matmul_i8 {name} M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
            t = time_ms(torch, [lambda w_=c: q4_matmul_i8_cuda(x, w_) for c in copies], 50)
            tp = time_ms(torch, [lambda w_=c: q4_matmul_i8_ref(x, w_) for c in copies], 10)
            record("q4_matmul_i8", f"{name} M={m} N={n} K={k}", err, bound, t, tp)
        if name == "lm_head":
            # K5 returns an id, so its error is measured in logits: how far the
            # plain logit of the kernel's id lies below the plain maximum
            lost, off_k1, off_plain, compared = [], 0, 0, 0
            for trial in range(GREEDY_TRIALS):
                x = torch.randn((1, k), device=dev, generator=g)
                tok = int(q4_greedy_cuda(x, w)[0])
                y = q4_matmul_i8_cuda(x, w)[0]
                y_ref = q4_matmul_i8_ref(x, w)[0]
                tok_ref = int(q4_greedy_ref(x, w)[0])
                torch.cuda.synchronize()
                off_k1 += tok != int(torch.argmax(y))
                bound = REL_BOUND * float(y_ref.abs().max())
                lost.append((float(y_ref.max() - y_ref[tok]), bound))
                top = y_ref.topk(2).values
                if float(top[0] - top[1]) > bound:
                    compared += 1
                    off_plain += tok != tok_ref
            require(off_k1 == 0, f"q4_greedy: {off_k1} of {GREEDY_TRIALS} ids != argmax(K1)")
            require(off_plain == 0,
                    f"q4_greedy: {off_plain} of {compared} ids != plain (top-2 gap over bound)")
            require(all(e <= b for e, b in lost),
                    f"q4_greedy: (max(plain) - plain[id], bound) per row {lost}")
            err, bound = max(lost, key=lambda eb: eb[0] / eb[1])
            t = time_ms(torch, [lambda w_=c: q4_greedy_cuda(x, w_) for c in copies], 50)
            tp = time_ms(torch, [lambda w_=c: q4_greedy_ref(x, w_) for c in copies], 10)
            record("q4_greedy", f"lm_head N={n} K={k}, {GREEDY_TRIALS} rows: ids != argmax(K1) "
                   f"{off_k1}/{GREEDY_TRIALS}, != plain id {off_plain}/{compared} (rows whose "
                   f"plain top-2 gap exceeds the bound); error = max(plain) - plain[id]",
                   err, bound, t, tp)
        del copies, w

    # K6d at the FFN shapes: M = 1 (decode) and the larger calls of <= 32 rows
    d, f = 2048, 5632
    gus, wds = weights(2 * f, d, 96_000_000), weights(d, f, 48_000_000)
    pairs = list(zip(gus, wds))
    gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    for m in FFN_ROWS:
        x = torch.randn((1, m, d), device=dev, generator=g)
        got = fused_ffn_norm_cuda(x, gamma, gus[0], wds[0], 1e-5)
        want = fused_ffn_norm_ref(x, gamma, gus[0], wds[0], 1e-5)
        torch.cuda.synchronize()
        err, bound = rel_err(got, want)
        require(bool(torch.isfinite(got).all()) and err <= bound,
                f"fused_ffn_norm M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
        t = time_ms(torch, [lambda p_=pr: fused_ffn_norm_cuda(x, gamma, p_[0], p_[1], 1e-5)
                            for pr in pairs], 50 if m == 1 else 10)
        tp = time_ms(torch, [lambda p_=pr: fused_ffn_norm_ref(x, gamma, p_[0], p_[1], 1e-5)
                             for pr in pairs], 20 if m == 1 else 10)
        record("fused_ffn_norm", f"M={m} D={d} F={f}", err, bound, t, tp)
    del gus, wds, pairs

    # K7 over a random stacked cache, layer ATTN_LAYER
    kc = torch.randn((L, 1, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((L, 1, HKV, S, D), device=dev, generator=g).to(torch.bfloat16)
    nqkv = (HQ + 2 * HKV) * D
    wqkvs, wos = weights(nqkv, 2048, 64_000_000), weights(2048, HQ * D, 64_000_000)
    layers = list(zip(wqkvs, wos))
    gamma = 1.0 + 0.1 * torch.randn(2048, device=dev, generator=g)
    for pos in ATTN_POS:
        x = torch.randn((1, 1, 2048), device=dev, generator=g)
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
                f"attn_block pos={pos}: (max_abs_err, bound) of x_out, k_cur, v_cur {errs}")
        rows = torch.arange(S, device=dev) != pos
        require(torch.equal(kc[ATTN_LAYER, 0, :, pos], got[1][0, :, 0].to(torch.bfloat16))
                and torch.equal(vc[ATTN_LAYER, 0, :, pos], got[2][0, :, 0].to(torch.bfloat16))
                and torch.equal(kc[..., rows, :], kr[..., rows, :])
                and torch.equal(vc[..., rows, :], vr[..., rows, :]),
                f"attn_block pos={pos}: cache row pos is not bf16(k_cur, v_cur), or another "
                f"row changed")
        t = time_ms(torch, [lambda l_=ly: attn_block_cuda(x, gamma, l_[0], l_[1], kc, vc,
                                                          ATTN_LAYER, pos_t, cos, sin, HQ,
                                                          HKV, 1e-5) for ly in layers], 50)
        tp = time_ms(torch, [lambda l_=ly: attn_block_ref(x, gamma, l_[0], l_[1], kc, vc,
                                                          ATTN_LAYER, pos, cos, sin, HQ,
                                                          HKV, 1e-5) for ly in layers], 20)
        worst = max(errs, key=lambda eb: eb[0] / eb[1])
        record("attn_block", f"pos={pos} layer={ATTN_LAYER} (x_out, k_cur, v_cur)",
               worst[0], worst[1], t, tp)
    del wqkvs, wos, layers

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
        record("flash_attention", f"Tq=128 q_offset={q_off} kv_len={kv_len}", err, 1e-5, t, tp)

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
        record("decode_attention", f"kv_len={kv_len}", err, 1e-5, t, tp)
    return results


def model_path() -> pathlib.Path:
    from zgml_tpu_torch.utils.synthetic import TINYLLAMA_1_1B, write_synthetic_llama_gguf
    path = ROOT / ".bench_cache" / f"tinyllama-1.1b-q4_0-seed{SEED}-std{WEIGHT_STD}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_synthetic_llama_gguf(str(path), TINYLLAMA_1_1B, seed=SEED, scale=WEIGHT_STD)
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


def load_model(torch, dev):
    from zgml_tpu_torch.io.llama_loader import load_llama
    path = model_path()
    t0 = time.perf_counter()
    model, gf = load_llama(str(path), device=dev)
    gf.close()
    torch.cuda.synchronize()
    log(f"  loaded in {time.perf_counter() - t0:.1f} s: {model.cfg}")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, model.cfg.vocab_size, n) for n in (7, 128, 300)]
    return model, prompts


def end_to_end(torch, model, prompts, name, summary):
    """Drive one path through the engine; returns (engine, launches)."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.sampling import SamplingParams

    set_path(name)
    eng = LlamaEngine(model, prefill_chunk=128)
    sampled = (LlamaEngine(model, prefill_chunk=128, sampling=SamplingParams(temperature=0.8))
               if name == "default" else None)
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
        flags=PATHS[name], launches=launches, placement=tiers, logits_err=err,
        logits_bound=bound, tokens_checked=n_cmp, tokens_all_equal=outs[0] == ref_toks,
        min_gap=min(gaps), outputs=outs)
    return eng, launches


def rates(torch, engines, prompt, card, summary):
    """pp128 and tg32 of every path, measured in turns: RATE_ROUNDS rounds of
    (default, unfused, unfused, default), one prefill and one 32-token
    decode_n per turn, so an order effect on the host falls on both paths
    alike; the median per path."""
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

    log("== 2. kernels vs plain torch on the card (TinyLlama-1.1B shapes)")
    checks = check_kernels(torch, dev)

    log("== 3. end to end: TinyLlama-1.1B Q4_0, the default path and the unfused path")
    model, prompts = load_model(torch, dev)
    engines, launches = {}, {}
    for name in PATHS:
        engines[name], launches[name] = end_to_end(torch, model, prompts, name, summary)

    log("== 4. rates (the paths in turns) and where the time goes")
    rates(torch, engines, prompts[2], card, summary)
    for name, eng in engines.items():
        set_path(name)
        profile(torch, eng, prompts[2], name, summary)

    kernels = []
    for name, (_, src, replaces) in KERNELS.items():
        cases = checks[name]
        by_path = {p: launches[p][name] for p in PATHS}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            max_abs_err=max(c["err"] for c in cases),
                            ms=sum(c["ms"] for c in cases),
                            plain_ms=sum(c["plain_ms"] for c in cases),
                            cases=cases))
    summary.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=nvcc_s, kernels=kernels)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
