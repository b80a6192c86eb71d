#!/usr/bin/env python3
"""Time the attention kernels, the decode kernels K7 / K6 / K6b / K4 / K8 /
K14 / K15, K1 / K5 (the int8 GEMV and the greedy head), K2 (the quantized
matmul), K11 (its dx), K12 (rmsnorm) and K13 (the fused elementwise chain)
of two checkouts of zgml_tpu_torch on one card, in turns (A, B, B, A by
default), each turn in its own process.

    python3 kernel_ab.py A_DIR B_DIR [--rounds N] [--gguf MODEL.gguf] [--decode] [--rates]
                         [--only K6b,K4,...] [--bits] [--prefill-bf16 0|1]
                         [--splits 2,4,8,...]

A_DIR and B_DIR are roots of checkouts (e.g. a `git archive` of the parent
unpacked under build/, and `.`). Each process imports zgml_tpu_torch from its
root, builds that root's kernels into the root's own build directory, and
times, with chip_smoke.time_ms (device time from torch.profiler), the
attention kernels at the smoke's TinyLlama-1.1B shapes and at head_dim 128
with n_rep 1 (Llama-2-7B): K3 on a 128-row chunk at (q_offset, kv_len) (0,
128), (128, 256) and (1408, 1536) of a bf16 cache, K9 at (0, 128) and (1408,
1536) of an int8 one, and K10f (training's forward with LSE), K10dq and
K10dkv (its backward, each called as the autograd backward calls it with no
precomputed delta) at the smoke's three cases (TinyLlama B 4 x T 512,
Llama-2-7B B 1 x T 512, and Tq 128 over kv_len 300 at q_offset 172); the
decode kernels (decode_us, alone with --decode): K7 at Q4_0 in its four
modes, TinyLlama-1.1B's f32 A phase over the bf16 and the int8 cache and
Llama-2-7B's int8 A phase over both, at pos 0, 200 and 2047 of a 4-layer
cache, K6d (Q4_0) and K6a (Q8_0) at TinyLlama-1.1B's FFN at M = 1, 8, 32
and K6c at Llama-2-7B's at M = 1, 8, K6b at both models' FFN at M = 1, 4,
7, 32, K4 at the smoke's cases over TinyLlama-1.1B's 22-layer bf16 cache
(batch 1 at kv_len 1, 200, 2047, and batch 4 at chip_smoke.DECODE_BATCH_LENS),
K8 at the smoke's (TinyLlama-1.1B batch 4, Llama-2-7B batch 1 at kv_len 200
and 2047; in both its modes where the checkout has the ZGML_TPU_ATTN_I8PV
one, "K8 i8pv ..."), and K14, K15 and K15 with f32 operands
over TinyLlama-1.1B's 22 Q4_0 layers and Llama-2-7B's widths over 4 at pos
0, 1, 200 and 2047 (the smoke's megacall cases), K1 at the smoke's cases
(chip_smoke.I8_ROWS on TinyLlama-1.1B's five projections at Q4_0 and Q8_0
and on Llama-2-7B's at Q4_0) and K5 at the smoke's (lm_head, the same
kinds and models); K11 at Q4_0 and Q8_0
on M = 512 rows of g at the five TinyLlama-1.1B projections (wqkv, wo,
w_gate_up, w_down, lm_head); K2 at Q4_0 and Q8_0 on a 128-row prefill chunk
at those five projections and at Llama-2-7B's (wqkv, wo, w_gate_up, w_down,
lm_head), on M = 512 (train_q4_frozen's forward) and on M = 8 and 32 (the
unfused path's small calls) at TinyLlama-1.1B's; weight copies cycled so
the 50 MB L2 is cold; K12 at the smoke's RMSNORM_CASES (f32) and K13 at its
chain_cases() (graph_ffn's two chains, one case per op at [2048, 2048], and
a bias [2048] added to [2048, 2048]), input copies cycled as the smoke does.
With --gguf (e.g. the Llama-2-7B file chip_smoke.py writes under
.bench_cache/) each turn also loads that model and times, on the host clock
around a synchronized call, the prefill of a 1536-token prompt (seeded ids,
128-row chunks) over the bf16 and the int8 KV cache: the median of 3 after
one warm-up, in us like the kernels. With --rates each turn also loads the
smoke's synthetic GGUFs (written under .bench_cache/ where missing) and
times every path of chip_smoke.PATHS end to end as the smoke's tg32 does: a
32-token decode_n after a 128-token prefill, on the host clock around
synchronized calls, the paths there and back RATE_RUNS times after a
warm-up round; the median per path, in host us a token. --only times only
the named families of the decode kernels (K7, K6, K6b, K4, K8, K14, K1, K5:
K14 takes K15 with it), and implies --decode. With --bits each turn also
hashes K8's and K1's outputs at fixed inputs (numpy-seeded: K8 at the
smoke's cases and a batch with a kv_len 0 row, K1 at M = 1, 4, 8, 32 of
TinyLlama-1.1B's wqkv and lm_head at both kinds, where --only names the
family), and the hashes are compared: each side the same bits on every
turn, and the two sides the same bits or not. --splits 2,4,... also times
K8, in both modes where a checkout has the I8PV one, at each of those split
counts in place of its plan's (through its C entry point). --prefill-bf16 sets
ZGML_TPU_PREFILL_BF16 in every turn (default 1, the JAX default) and times
K2, K3, K9 and K10 in the form a checkout's dispatch takes under it: the bf16
forms where the checkout has them (a K2 call whose JAX row tile holds 32 rows
or more), the f32 (TF32) forms where it has none or the flag is 0; so `A_DIR
B_DIR --prefill-bf16 1` times a parent without them against its change.
Prints one JSON line per turn, then the median per case and side, with the
card's name and power limit.
"""
from __future__ import annotations

import functools
import importlib.util
import inspect
import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def wanted(family: str) -> bool:
    """Whether --only (if given) names this decode kernel family."""
    if "--only" not in sys.argv:
        return True
    return family in sys.argv[sys.argv.index("--only") + 1].split(",")


def prefill_us(torch, gguf: str) -> dict:
    """Host us of a 1536-token prefill of the model at `gguf` per cache type."""
    import time

    import numpy as np
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    model, gf = load_llama(gguf, device="cuda")
    gf.close()
    ids = np.random.default_rng(0).integers(0, model.cfg.vocab_size, 1536)
    out = {}
    for cache in ("bf16", "int8"):
        eng = LlamaEngine(model, prefill_chunk=128, cache_dtype=cache)
        runs = []
        for _ in range(4):
            eng.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(ids)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out[f"prefill 1536 tokens, {cache} cache (host)"] = statistics.median(runs[1:]) * 1e6
        del eng
        torch.cuda.empty_cache()
    return out


RATE_RUNS = 3     # --rates: timed rounds of the paths there and back in a turn


def path_rates(torch, smoke) -> dict:
    """Host us a token of each smoke path's tg32 (see the module's --rates)."""
    import time

    import numpy as np
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    dev = torch.device("cuda")
    models = {m: smoke.load_model(torch, dev, *m) for m in dict.fromkeys(smoke.PATH_MODEL.values())}
    tiny = models["tinyllama-1.1b", "q4_0"]
    if not (tiny.enable_stacked_decode() and tiny.enable_tape_decode()):
        raise RuntimeError("TinyLlama-1.1B Q4_0: the megacall views were refused")
    vocab = min(m.cfg.vocab_size for m in models.values())
    prompt = np.random.default_rng(smoke.SEED).integers(0, vocab, 128)
    engines = {name: LlamaEngine(models[smoke.PATH_MODEL[name]], prefill_chunk=128,
                                 cache_dtype=smoke.PATH_CACHE.get(name, "bf16"))
               for name in smoke.PATHS}
    runs = {name: [] for name in engines}
    order = list(engines) + list(engines)[::-1]
    for r in range(RATE_RUNS + 1):
        for name in order:
            smoke.set_path(name)
            eng = engines[name]
            eng.reset()
            tok = torch.argmax(eng.prefill(prompt), dim=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.decode_n(tok, 32)
            torch.cuda.synchronize()
            if r:
                runs[name].append(time.perf_counter() - t0)
    smoke.set_path("default")
    return {f"tg32 {name} (host us a token)": statistics.median(v) / 32 * 1e6
            for name, v in runs.items()}


def weight_copies(torch, dev, g, kind, n, k, total=48_000_000):
    """Copies of a random [n, k] weight of `kind` totalling >= `total`
    bytes (48 MB: the 50 MB L2 stays cold as the calls cycle)."""
    from zgml_tpu_torch.quant.packed import PackedWeight
    per = n * k // (2 if kind == "q4_0" else 1) + n * k // 16
    copies = []
    for _ in range(max(2, -(-total // per))):
        d = (torch.rand((n, k // 32), device=dev, generator=g) * 0.02 + 0.001).half()
        if kind == "q4_0":
            qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=dev,
                               generator=g)
        else:
            qs = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=g)
            d = d / 16
        copies.append(PackedWeight(n, k, qs, d, kind))
    return copies


def decode_us(torch, dev, g, time_ms, smoke) -> dict:
    """Device ms of the decode kernels K7 (its four modes), K6 (K6d, K6a,
    K6c), K6b, K4, K8 and the megacalls K14 / K15."""
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.attention import decode_attention_cuda, decode_attention_q8_cuda
    from zgml_tpu_torch.ops.ffn import fused_ffn_cuda, fused_ffn_norm_cuda
    from zgml_tpu_torch.ops.layerkernel import attn_block_cuda
    from zgml_tpu_torch.ops.stackkernel import StackedLayers, stacked_decode_cuda
    from zgml_tpu_torch.ops.tapekernel import Tape, tape_decode_cuda
    copies_of = functools.partial(weight_copies, torch, dev, g)
    out = {}

    # K7 in its four modes at Q4_0: TinyLlama-1.1B's f32 A phase over the
    # bf16 and the int8 cache, Llama-2-7B's int8 A phase over both
    for tag, (hq, hkv, hd), a_i8 in (("", (32, 4, 64), False), ("7B ", (32, 32, 128), True)):
        if not wanted("K7"):
            break
        d = hq * hd
        layers = list(zip(copies_of("q4_0", (hq + 2 * hkv) * hd, d, 32_000_000),
                          copies_of("q4_0", d, hq * hd, 24_000_000)))
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        x = torch.randn((1, 1, d), device=dev, generator=g)
        for kv8 in (False, True):
            shape = (4, 1, hkv, 2048, hd)
            if kv8:
                ck = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g),
                      torch.rand(shape[:-1], device=dev, generator=g) * 0.01 + 0.01)
                cv = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g),
                      torch.rand(shape[:-1], device=dev, generator=g) * 0.01 + 0.01)
            else:
                ck = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                cv = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
            mode = ("i8" if a_i8 else "f32") + ("-kv8" if kv8 else "")
            for p in (0, 200, 2047):
                cos, sin = refs.rope_cos_sin(torch.tensor([p], device=dev), hd)
                pos = torch.tensor([p], dtype=torch.int32, device=dev)
                out[f"K7 {tag}{mode} pos={p}"] = time_ms(torch, [
                    lambda l_=ly: attn_block_cuda(x, gamma, *l_, ck, cv, 3, pos, cos, sin, hq,
                                                  hkv, 1e-5, a_i8) for ly in layers], 50)[0]
            del ck, cv
        del layers
    # K6: K6d (Q4_0) and K6a (Q8_0) at TinyLlama-1.1B's FFN, K6c at Llama-2-7B's
    for name, kind, d, f, a_i8, rows in (("K6d", "q4_0", 2048, 5632, False, (1, 8, 32)),
                                         ("K6a", "q8_0", 2048, 5632, False, (1, 8, 32)),
                                         ("K6c 7B", "q4_0", 4096, 11008, True, (1, 8))):
        if not wanted("K6"):
            break
        pairs = list(zip(copies_of(kind, 2 * f, d, 64_000_000), copies_of(kind, d, f, 32_000_000)))
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        for m in rows:
            x = torch.randn((1, m, d), device=dev, generator=g)
            out[f"{name} M={m}"] = time_ms(torch, [
                lambda p_=pr: fused_ffn_norm_cuda(x, gamma, *p_, 1e-5, a_i8) for pr in pairs],
                50 if m == 1 else 10)[0]
        del pairs
    # K6b at TinyLlama-1.1B's and Llama-2-7B's FFN (the smoke's rows and M 4)
    for tag, d, f in (("", 2048, 5632), ("7B ", 4096, 11008)):
        if not wanted("K6b"):
            break
        pairs = list(zip(copies_of("q4_0", 2 * f, d, 64_000_000),
                         copies_of("q4_0", d, f, 32_000_000)))
        for m in (1, 4, 7, 32):
            h = torch.randn((1, m, d), device=dev, generator=g)
            out[f"K6b {tag}M={m}"] = time_ms(torch, [lambda p_=pr: fused_ffn_cuda(h, *p_)
                                                     for pr in pairs], 50 if m <= 4 else 20)[0]
        del pairs
    # K4 at the smoke's cases: batch 1 at kv_len 1, 200, 2047 and batch 4 with
    # per-row kv_len over TinyLlama-1.1B's 22-layer bf16 cache
    kc = torch.randn((22, 4, 2048, 64), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((22, 4, 2048, 64), device=dev, generator=g).to(torch.bfloat16)
    for lens_, row in [([n], 3) for n in (1, 200, 2047)] + [(smoke.DECODE_BATCH_LENS, 2)]:
        if not wanted("K4"):
            break
        q = torch.randn((len(lens_), 32, 1, 64), device=dev, generator=g)
        lens = torch.tensor(lens_, dtype=torch.int32, device=dev)
        out[f"K4 B={len(lens_)} kv_len={lens_}"] = time_ms(
            torch, [lambda: decode_attention_cuda(q, kc, vc, lens, row)], 100)[0]
    del kc, vc
    # K8 at the smoke's cases: TinyLlama-1.1B batch 4, Llama-2-7B batch 1; in
    # its I8PV mode too where the checkout has it ("K8 i8pv ..."), and there
    # with --splits at those split counts too ("... n_split=N")
    modes = [("", {})] + ([("i8pv ", {"i8pv": True})] if "i8pv" in inspect.signature(
        decode_attention_q8_cuda).parameters else [])
    splits = ([int(n) for n in sys.argv[sys.argv.index("--splits") + 1].split(",")]
              if "--splits" in sys.argv else [])
    for tag, (hq, hkv, hd), cases in (("", (32, 4, 64), smoke.KV8_DECODE_LENS),
                                      ("7B ", (32, 32, 128), smoke.KV8_DECODE_LENS_7B)):
        if not wanted("K8"):
            break
        shape = (22 if not tag else 4, hkv, 2048, hd)
        k8 = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
        v8 = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
        ks = torch.rand(shape[:3], device=dev, generator=g) * 0.01 + 0.01
        vs = torch.rand(shape[:3], device=dev, generator=g) * 0.01 + 0.01
        for lens_ in cases:
            q = torch.randn((len(lens_), hq, 1, hd), device=dev, generator=g)
            lens = torch.tensor(lens_, dtype=torch.int32, device=dev)
            for mode, kw in modes:
                def call(kw=kw):
                    return decode_attention_q8_cuda(q, k8, ks, v8, vs, lens, 0, **kw)
                out[f"K8 {mode}{tag}B={len(lens_)} kv_len={lens_}"] = time_ms(torch, [call],
                                                                              100)[0]
            for n_split in splits if len(modes) > 1 else ():
                for mode, i8pv in (("", False), ("i8pv ", True)):
                    out[f"K8 {mode}{tag}B={len(lens_)} kv_len={lens_} n_split={n_split}"] = \
                        time_ms(torch, [k8_at_split(torch, q, k8, ks, v8, vs, lens, n_split,
                                                    i8pv)], 100)[0]
        del k8, v8, ks, vs
    # K14, K15 and K15 with f32 operands (tape_f32) at the smoke's megacall
    # cases: TinyLlama-1.1B's 22 Q4_0 layers and Llama-2-7B's widths over 4
    for tag, (n_layers, hq, hkv, hd, f) in (("", (22, 32, 4, 64, 5632)),
                                            ("7B ", (4, 32, 32, 128, 11008))):
        if not wanted("K14"):
            break
        d = hq * hd
        layers = [{"attn_norm": 1.0 + 0.1 * torch.randn(d, device=dev, generator=g),
                   "ffn_norm": 1.0 + 0.1 * torch.randn(d, device=dev, generator=g),
                   "wqkv": copies_of("q4_0", (hq + 2 * hkv) * hd, d, 1)[0],
                   "wo": copies_of("q4_0", d, d, 1)[0],
                   "w_gate_up": copies_of("q4_0", 2 * f, d, 1)[0],
                   "w_down": copies_of("q4_0", d, f, 1)[0]} for _ in range(n_layers)]
        stack = StackedLayers(layers, hq, hkv, 1e-5)
        tape = Tape(stack, ())
        ck = torch.randn((n_layers, 1, hkv, 2048, hd), device=dev, generator=g).to(torch.bfloat16)
        cv = torch.randn((n_layers, 1, hkv, 2048, hd), device=dev, generator=g).to(torch.bfloat16)
        x = torch.randn((1, 1, d), device=dev, generator=g)
        for p in (0, 1, 200, 2047):
            cos, sin = refs.rope_cos_sin(torch.tensor([p], device=dev), hd)
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            out[f"K14 {tag}pos={p}"] = time_ms(
                torch, [lambda: stacked_decode_cuda(x, stack, ck, cv, pos, cos, sin)], 20)[0]
            for name, bf16 in (("K15", True), ("K15 f32", False)):
                out[f"{name} {tag}pos={p}"] = time_ms(
                    torch, [lambda: tape_decode_cuda(x, tape, ck, cv, pos, cos, sin, bf16=bf16)],
                    20)[0]
        del layers, stack, tape, ck, cv
    # K1 at the smoke's cases, K5 on their lm_head
    from zgml_tpu_torch.ops.qmatmul import greedy_cuda, qmatmul_i8_cuda
    for tag, shapes, kinds in (("", smoke.GEMM_SHAPES, ("q4_0", "q8_0")),
                               ("7B ", smoke.GEMM_SHAPES_7B, ("q4_0",))):
        if not (wanted("K1") or wanted("K5")):
            break
        for kind in kinds:
            for name, n, k in shapes:
                if name != "lm_head" and not wanted("K1"):
                    continue
                copies = copies_of(kind, n, k)
                for m in smoke.I8_ROWS if wanted("K1") else ():
                    x = torch.randn((m, k), device=dev, generator=g)
                    out[f"K1 {kind} {tag}{name} M={m}"] = time_ms(
                        torch, [lambda w_=c: qmatmul_i8_cuda(x, w_) for c in copies], 50)[0]
                if name == "lm_head" and wanted("K5"):
                    x = torch.randn((1, k), device=dev, generator=g)
                    out[f"K5 {kind} {tag}lm_head"] = time_ms(
                        torch, [lambda w_=c: greedy_cuda(x, w_) for c in copies], 50)[0]
                del copies
    return out


def k8_at_split(torch, q, k, ks, v, vs, lens, n_split: int, i8pv: bool):
    """A call of K8 through its C entry point at n_split blocks per (batch
    row, KV head) in place of its plan's (ops/attention.py decode_q8_splits),
    over cache rows from 0."""
    from zgml_tpu_torch.ops import attention, build, coop
    lib = build.library()
    b, hq, _, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    part = torch.empty((b * hq, n_split, hd + 2), device=q.device)
    words = coop.counter_words(q.device, b * hkv).data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        build.check(lib.zgml_decode_attention_q8(
            q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
            lens.data_ptr(), o.data_ptr(), part.data_ptr(), words, b, hq, hkv, s, hd, 0, n_split,
            attention.k8_block(s), int(i8pv), 1.0 / hd ** 0.5, stream), "K8")
    return call


def k1_bits(torch, dev) -> dict:
    """sha256 of K1's output bytes at fixed numpy-seeded inputs, per case."""
    import hashlib

    import numpy as np
    from zgml_tpu_torch.ops.qmatmul import qmatmul_i8_cuda
    from zgml_tpu_torch.quant.packed import PackedWeight
    out = {}
    for kind in ("q4_0", "q8_0"):
        for name, n, k in (("wqkv", 2560, 2048), ("lm_head", 32000, 2048)):
            rng = np.random.default_rng(n + len(kind))
            d = torch.from_numpy(rng.uniform(0.001, 0.021, (n, k // 32)).astype(np.float16))
            if kind == "q4_0":
                qs = torch.from_numpy(rng.integers(0, 256, (n, k // 2), dtype=np.uint8))
            else:
                qs = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
            w = PackedWeight(n, k, qs.to(dev), d.to(dev), kind)
            for m in (1, 4, 8, 32):
                x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
                out[f"K1 bits {kind} {name} M={m}"] = hashlib.sha256(
                    qmatmul_i8_cuda(x, w).cpu().numpy().tobytes()).hexdigest()
    return out


def k8_bits(torch, dev) -> dict:
    """sha256 of K8's output bytes at fixed numpy-seeded inputs, per case (and
    per mode where the checkout has the I8PV one)."""
    import hashlib

    import numpy as np
    from zgml_tpu_torch.ops.attention import decode_attention_q8_cuda
    out = {}
    for b, hq, hkv, hd, rows, lens in ((4, 32, 4, 64, 22, [1, 200, 2047, 1000]),
                                       (1, 32, 32, 128, 4, [200]), (1, 32, 32, 128, 4, [2047]),
                                       (2, 8, 2, 16, 3, [0, 64])):
        rng = np.random.default_rng(hd + b)
        q = torch.from_numpy(rng.standard_normal((b, hq, 1, hd)).astype(np.float32)).to(dev)
        lv = [torch.from_numpy(rng.integers(-127, 128, (rows, hkv, 2048, hd), dtype=np.int8))
              .to(dev) for _ in range(2)]
        sc = [torch.from_numpy(rng.uniform(0.01, 0.02, (rows, hkv, 2048)).astype(np.float32))
              .to(dev) for _ in range(2)]
        modes = [("", {})] + ([("i8pv ", {"i8pv": True})] if "i8pv" in inspect.signature(
            decode_attention_q8_cuda).parameters else [])
        for mode, kw in modes:
            o = decode_attention_q8_cuda(q, lv[0], sc[0], lv[1], sc[1],
                                         torch.tensor(lens, dtype=torch.int32, device=dev), 1,
                                         **kw)
            out[f"K8 {mode}bits hd={hd} B={b} kv_len={lens}"] = hashlib.sha256(
                o.cpu().numpy().tobytes()).hexdigest()
    return out


def one(root: str, gguf: str | None = None, decode_only: bool = False,
        rates: bool = False) -> dict:
    """The timings of the checkout at `root`, in this process (with
    decode_only, those of decode_us alone; with rates, and path_rates')."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch
    import zgml_tpu_torch
    from zgml_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_q8_cuda
    from zgml_tpu_torch.ops.flash_vjp import flash_dkv_cuda, flash_dq_cuda, flash_fwd_lse_cuda
    from zgml_tpu_torch.ops.elementwise import BINARY, fused_chain_cuda
    from zgml_tpu_torch.ops.qmatmul import qmatmul_bwd_cuda, qmatmul_cuda
    from zgml_tpu_torch.ops.rmsnorm import rmsnorm_cuda
    # this file's chip_smoke, not the checkout's: both sides time alike
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    time_ms, copies_for = smoke.time_ms, smoke.copies_for

    src = pathlib.Path(zgml_tpu_torch.__file__).resolve()
    if pathlib.Path(root).resolve() not in src.parents:
        raise RuntimeError(f"imported {src}, not the checkout at {root}")
    # the form this checkout's dispatch takes under ZGML_TPU_PREFILL_BF16
    from zgml_tpu_torch.ops import qmatmul as qmm
    bf16 = (os.environ.get("ZGML_TPU_PREFILL_BF16", "1") != "0"
            and "bf16" in inspect.signature(qmatmul_cuda).parameters)
    fkw = {"bf16": True} if bf16 else {}

    def k2_kw(m):
        return fkw if bf16 and qmm.row_tile(m) >= qmm.BF16_MIN_TILE else {}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bits = {}
    if "--bits" in sys.argv:
        bits.update(k8_bits(torch, dev) if wanted("K8") else {})
        bits.update(k1_bits(torch, dev) if wanted("K1") else {})
    if decode_only:
        out = {k: v * 1e3 for k, v in decode_us(torch, dev, g, time_ms, smoke).items()}
        return {**out, **bits, **path_rates(torch, smoke)} if rates else {**out, **bits}
    out = {}
    for hq, hkv, hd, tag in ((32, 4, 64, ""), (32, 32, 128, "7B ")):
        kc = torch.randn((22, hkv, 2048, hd), device=dev, generator=g).to(torch.bfloat16)
        vc = torch.randn((22, hkv, 2048, hd), device=dev, generator=g).to(torch.bfloat16)
        for q_off, kv_len in ((0, 128), (128, 256), (1408, 1536)):
            q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
            out[f"K3 {tag}hd={hd} q_offset={q_off} kv_len={kv_len}"] = time_ms(
                torch, [lambda: flash_attention_cuda(q, kc, vc, kv_len, q_off, 1, **fkw)], 50)[0]
        k8 = torch.randint(-127, 128, (22, hkv, 2048, hd), dtype=torch.int8, device=dev,
                           generator=g)
        v8 = torch.randint(-127, 128, (22, hkv, 2048, hd), dtype=torch.int8, device=dev,
                           generator=g)
        ks = torch.rand((22, hkv, 2048), device=dev, generator=g) * 0.01 + 0.01
        vs = torch.rand((22, hkv, 2048), device=dev, generator=g) * 0.01 + 0.01
        for q_off, kv_len in ((0, 128), (1408, 1536)):
            q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
            out[f"K9 {tag}hd={hd} q_offset={q_off} kv_len={kv_len}"] = time_ms(
                torch, [lambda: flash_attention_q8_cuda(q, k8, ks, v8, vs, kv_len, q_off, 3,
                                                        **fkw)], 50)[0]
        del k8, v8, ks, vs
    for b, hq, hkv, tq, s, hd, kv_len, q_off in ((4, 32, 4, 512, 512, 64, 512, 0),
                                                 (1, 32, 32, 512, 512, 128, 512, 0),
                                                 (1, 32, 4, 128, 512, 64, 300, 172)):
        q = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        k = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        shape = f"B={b} Hkv={hkv} hd={hd} Tq={tq} kv_len={kv_len} q_offset={q_off}"
        out[f"K10f {shape}"] = time_ms(
            torch, [lambda: flash_fwd_lse_cuda(q, k, v, kv_len, q_off, **fkw)], 20)[0]
        do = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        o, lse = flash_fwd_lse_cuda(q, k, v, kv_len, q_off, **fkw)
        bargs = (q, k, v, do, o, lse, kv_len, q_off)
        out[f"K10dq {shape}"] = time_ms(torch, [lambda: flash_dq_cuda(*bargs, **fkw)], 20)[0]
        out[f"K10dkv {shape}"] = time_ms(torch, [lambda: flash_dkv_cuda(*bargs, **fkw)],
                                         20)[0]
    copies_of = functools.partial(weight_copies, torch, dev, g)
    out.update(decode_us(torch, dev, g, time_ms, smoke))

    tiny = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w_gate_up", 11264, 2048),
            ("w_down", 2048, 5632), ("lm_head", 32000, 2048))
    for kind in ("q4_0", "q8_0"):
        for name, n, k in tiny:
            copies = copies_of(kind, n, k)
            gr = torch.randn((512, n), device=dev, generator=g)
            out[f"K11 {kind} {name} M=512 N={n} K={k}"] = time_ms(
                torch, [lambda w_=c: qmatmul_bwd_cuda(gr, w_) for c in copies], 10)[0]
            del copies
    for kind in ("q4_0", "q8_0"):
        for tag, shapes, rows in (("", tiny, (8, 32, 128, 512)),
                                  ("7B ", smoke.GEMM_SHAPES_7B, (128,))):
            for name, n, k in shapes:
                copies = copies_of(kind, n, k)
                for m in rows:
                    x = torch.randn((m, k), device=dev, generator=g)
                    out[f"K2 {kind} {tag}{name} M={m} N={n} K={k}"] = time_ms(
                        torch, [lambda w_=c: qmatmul_cuda(x, w_, **k2_kw(m)) for c in copies],
                        20)[0]
                del copies
    for m, d in smoke.RMSNORM_CASES:
        xs = [torch.randn((m, d), device=dev, generator=g)
              for _ in range(copies_for(2 * m * d * 4))]
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        out[f"K12 M={m} d={d}"] = time_ms(
            torch, [lambda x_=x: rmsnorm_cuda(x_, gamma) for x in xs], 50)[0]
    for label, steps, shape, side_shape in smoke.chain_cases():
        n_sides = sum(st.op in BINARY for st in steps)
        side_shape = shape if side_shape is None else side_shape
        nbytes = (2 + n_sides) * shape[0] * shape[1] * 4
        sets = [(torch.randn(shape, device=dev, generator=g).abs() + 0.05,
                 [torch.randn(side_shape, device=dev, generator=g) for _ in range(n_sides)])
                for _ in range(copies_for(nbytes, 160_000_000, 8))]
        out[f"K13 {label} {list(shape)}"] = time_ms(
            torch, [lambda s_=st: fused_chain_cuda(s_[0], steps, s_[1]) for st in sets], 20)[0]
    out = {k: v * 1e3 for k, v in out.items()}            # device us
    if gguf:
        out.update(prefill_us(torch, gguf))
    if rates:
        out.update(path_rates(torch, smoke))
    return {**out, **bits}


def main() -> int:
    gguf = sys.argv[sys.argv.index("--gguf") + 1] if "--gguf" in sys.argv else None
    decode_only = "--decode" in sys.argv or "--only" in sys.argv
    rates = "--rates" in sys.argv
    if "--prefill-bf16" in sys.argv:
        os.environ["ZGML_TPU_PREFILL_BF16"] = sys.argv[sys.argv.index("--prefill-bf16") + 1]
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2], gguf, decode_only, rates)))
        return 0
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) if "--rounds" in sys.argv else 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {a: [], b: []}
    for side in [a, b, b, a] * rounds:
        proc = subprocess.run([sys.executable, __file__, "--one", side]
                              + (["--gguf", str(pathlib.Path(gguf).resolve())] if gguf else [])
                              + (["--decode"] if decode_only else [])
                              + (["--rates"] if rates else [])
                              + (sys.argv[sys.argv.index("--only"):][:2]
                                 if "--only" in sys.argv else [])
                              + (sys.argv[sys.argv.index("--splits"):][:2]
                                 if "--splits" in sys.argv else [])
                              + (["--bits"] if "--bits" in sys.argv else []),
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{side}: {proc.stderr[-3000:]}")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(side, proc.stdout.strip().splitlines()[-1], flush=True)
    print(card, "ZGML_TPU_PREFILL_BF16=" + os.environ.get("ZGML_TPU_PREFILL_BF16", "1"))
    for case in dict.fromkeys([*runs[a][0], *runs[b][0]]):
        sides = [side for side in (a, b) if case in runs[side][0]]
        if len(sides) == 1:                         # a case one checkout lacks (a new mode)
            vals = [r[case] for r in runs[sides[0]]]
            shown = (f"{statistics.median(vals):8.1f} us" if not isinstance(vals[0], str)
                     else f"{len(set(vals))} distinct bits over its turns")
            print(f"{case:58s} only {sides[0]}: {shown}")
            continue
        if isinstance(runs[a][0][case], str):       # --bits: a hash a turn
            sa, sb = {r[case] for r in runs[a]}, {r[case] for r in runs[b]}
            if len(sa) == 1 and len(sb) == 1:
                print(f"{case:58s} each side the same bits on every turn; the sides "
                      f"{'agree' if sa == sb else 'differ'}")
            else:
                print(f"{case:58s} DIFFERENT bits between turns of one side")
            continue
        ma = statistics.median(r[case] for r in runs[a])
        mb = statistics.median(r[case] for r in runs[b])
        print(f"{case:58s} {a}: {ma:8.1f} us  {b}: {mb:8.1f} us  ({100 * (mb / ma - 1):+.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
