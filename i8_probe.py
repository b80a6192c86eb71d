#!/usr/bin/env python3
"""Probes of K1 / K5 (zgml_tpu_torch/csrc/qmatmul_i8.cu) on one CUDA card.

    python3 i8_probe.py plans [CASES]   # K1 / K5 under plans of other stage sizes and `ahead`
    python3 i8_probe.py stamps [CASES]  # %globaltimer stamps of block 0, stage by stage

CASES is a JSON list of [kind, n, k, m, greedy] (greedy 1: K5, m 1); the
default is the cases the findings in PERF.md cite. `plans` times each case
(chip_smoke.time_ms, device time) under the plan of each of PLAN_VARIANTS
(ops/qmatmul.py I8_STAGE_BYTES, and the producer's `ahead` where not -1), in
turns, on the checkout's library. `stamps` compiles a copy of the kernel
source with %globaltimer stamps (build/i8_probe/stamp_i8.cu, nvcc -shared,
loaded with ctypes; the stamp buffer is passed in xs_out, so a stamp reads no
global pointer) and prints, for block 0, the prologue (consumer start, x
landed or quantized into the global scratch, grid barrier passed, x staged)
and per stage: the wait for the slot, the words of the first item loaded and
rotated, its scales, its dots, the barrier after the partial sums, the end of
the reduce, and when the producer issued the stage's copies (us from the
consumers' start). The copy is made by replacing lines of the source: an
edit of those lines makes `stamps` fail with the line it could not find.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
DEFAULT_CASES = [["q4_0", 32000, 2048, 1, 0], ["q4_0", 32000, 2048, 1, 1],
                 ["q8_0", 32000, 2048, 1, 0], ["q8_0", 32000, 2048, 1, 1],
                 ["q8_0", 2560, 2048, 1, 0], ["q8_0", 11264, 2048, 1, 0],
                 ["q4_0", 2560, 2048, 32, 0], ["q4_0", 2048, 2048, 32, 0],
                 ["q4_0", 2048, 5632, 32, 0], ["q4_0", 32000, 2048, 32, 0]]
PLAN_VARIANTS = [[32768, -1], [73728, -1], [73728, 0], [106496, -1]]
NAMES = ["wait", "full", "words", "scales", "dots", "sync", "end", "copy"]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def setup():
    sys.path.insert(0, str(ROOT))
    import torch
    import kernel_ab
    spec = importlib.util.spec_from_file_location("i8_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return torch, kernel_ab, smoke


def launcher(lib, torch, q, kind, n, k, m, greedy, x, ints, xq_out=None, xs_out=None):
    """A call of the library's K1 (or K5) with the given plan ints."""
    from zgml_tpu_torch.ops import coop
    dev = x.device
    plan = q.i8_plan(m, n, k, kind, torch.cuda.get_device_properties(dev).multi_processor_count)
    y = torch.empty((m, n), device=dev)
    out = torch.empty(1, dtype=torch.int64, device=dev)
    scr = coop.scratch(dev, q.i8_scratch_bytes(plan, m, k, greedy=True))
    bar, tick = coop.barrier_words(dev), coop.counter_words(dev, 1)
    st = torch.cuda.current_stream().cuda_stream
    code = q.KIND_CODE[kind]
    if greedy:
        return lambda w: lib.zgml_greedy(code, x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(),
                                         out.data_ptr(), scr.data_ptr(), bar.data_ptr(),
                                         tick.data_ptr(), n, k, ints, dev.index, st)
    return lambda w: lib.zgml_qmatmul_i8(code, x.data_ptr(), w.qs.data_ptr(), w.d.data_ptr(),
                                         y.data_ptr(), xq_out, xs_out, scr.data_ptr(),
                                         bar.data_ptr(), m, n, k, ints, dev.index, st)


def plans(cases):
    torch, kernel_ab, smoke = setup()
    from zgml_tpu_torch.ops import build, qmatmul as q
    lib = build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for kind, n, k, m, greedy in cases:
        copies = kernel_ab.weight_copies(torch, dev, g, kind, n, k)
        x = torch.randn((m, k), device=dev, generator=g)
        for rnd in range(2):
            for stage_bytes, ahead in PLAN_VARIANTS if rnd == 0 else PLAN_VARIANTS[::-1]:
                q.I8_STAGE_BYTES = stage_bytes
                plan = q.i8_plan(m, n, k, kind, sms)
                iv = q.i8_ints(plan)
                if ahead >= 0:
                    iv[4] = ahead
                ints = (ctypes.c_int * len(iv))(*iv)
                call = launcher(lib, torch, q, kind, n, k, m, greedy, x, ints)
                build.check(call(copies[0]), "qmatmul_i8")
                t = smoke.time_ms(torch, [lambda w_=c: call(w_) for c in copies], 50)[0] * 1e3
                label = f"{stage_bytes // 1024}K S={plan.S} stages={plan.stages} ahead={iv[4]}"
                res.setdefault(f"{'K5' if greedy else 'K1'} {kind} n={n} k={k} m={m}",
                               {}).setdefault(label, []).append(t)
    print(card())
    for case, d in res.items():
        print(case + ": " + "; ".join(f"{nm} {sum(v) / len(v):.1f} us" for nm, v in d.items()))


def _rep(src: str, a: str, b: str) -> str:
    if src.count(a) != 1:
        raise RuntimeError(f"i8_probe stamps: the source no longer holds: {a.strip()[:80]!r}")
    return src.replace(a, b)


def stamped_source() -> str:
    """csrc/qmatmul_i8.cu with STAMP(stage, point) at the points NAMES lists
    (row 63 of a warp: the prologue)."""
    src = (ROOT / "zgml_tpu_torch/csrc/qmatmul_i8.cu").read_text()
    src = _rep(src, "namespace {\n\nconstexpr int TILE = 16;", """__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(n, k) do { if (stp != nullptr && blockIdx.x == 0 && (threadIdx.x & 31) == 0) \\
  stp[((threadIdx.x >> 5) * 64 + ((n) & 63)) * 8 + (k)] = gtime(); } while (0)

namespace {

constexpr int TILE = 16;""")
    src = _rep(src, """const uint8_t* xf, const float* xs, int M, int m0, int lane,
                                     float (&acc)[NT][4]) {""", """const uint8_t* xf, const float* xs, int M, int m0, int lane,
                                     float (&acc)[NT][4], int pn, long long* stp) {""")
    src = _rep(src, "    // the group's scales of rows g, g + 8, as fp16 pairs",
               "    STAMP(pn, 2);\n    // the group's scales of rows g, g + 8, as fp16 pairs")
    src = _rep(src, "    // block cl of the group: the A fragment",
               "    { volatile uint32_t z = dl[0] + dh[0]; (void)z; }\n    STAMP(pn, 3);\n"
               "    // block cl of the group: the A fragment")
    src = _rep(src, "tile_rows, xf, xs, p.M, m0, lane, acc);",
               "tile_rows, xf, xs, p.M, m0, lane, acc, n, stp);\n"
               "    { volatile float z = acc[0][0]; (void)z; }\n    STAMP(n, 4);")
    src = _rep(src, "    ws::mbar_wait(ws::full_bar(smem, slot), (n / a.ring.stages) & 1);\n",
               "    STAMP(n, 0);\n    ws::mbar_wait(ws::full_bar(smem, slot), (n / a.ring.stages) & 1);\n"
               "    STAMP(n, 1);\n")
    src = _rep(src, "    ws::sync();\n    // each output: its tile's P partial sums",
               "    ws::sync();\n    STAMP(n, 5);\n    // each output: its tile's P partial sums")
    src = _rep(src, "      ws::sync();                           // part is rewritten by the next stage\n    }",
               "      ws::sync();                           // part is rewritten by the next stage\n"
               "    }\n    STAMP(n, 6);")
    src = _rep(src, "        ws::mbar_wait(ws::empty_bar(smem, slot), ((n / a.ring.stages) & 1) ^ 1);\n",
               "        ws::mbar_wait(ws::empty_bar(smem, slot), ((n / a.ring.stages) & 1) ^ 1);\n"
               "        STAMP(n, 7);\n")
    src = _rep(src, "  ws::ring_init(smem, a.ring);\n  const int tr = a.tr;",
               "  ws::ring_init(smem, a.ring);\n"
               "  long long* stp = reinterpret_cast<long long*>(p.xs_out);\n  const int tr = a.tr;")
    src = _rep(src, "  // 1. the int8 activations\n  if (a.self_q) {\n    ws::mbar_wait(ws::x_bar(smem), 0);",
               "  // 1. the int8 activations\n  STAMP(63, 0);\n  if (a.self_q) {\n"
               "    ws::mbar_wait(ws::x_bar(smem), 0);\n    STAMP(63, 1);")
    src = _rep(src, "    gb.wait();\n", "    STAMP(63, 1);\n    gb.wait();\n    STAMP(63, 2);\n")
    src = _rep(src, "    ws::release(smem, 1);                   // the producer may run past `ahead`",
               "    ws::release(smem, 1);                   // the producer may run past `ahead`\n"
               "    STAMP(63, 3);")
    return src.replace("p.xq_out != nullptr", "false")


def stamps(cases):
    torch, kernel_ab, _ = setup()
    from zgml_tpu_torch.ops import build, qmatmul as q
    out = ROOT / "build" / "i8_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "stamp_i8.cu").write_text(stamped_source())
    so = out / "libstamp_i8.so"
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                        str(ROOT / "zgml_tpu_torch/csrc"), str(out / "stamp_i8.cu"), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.zgml_qmatmul_i8.argtypes = (I, *(P,) * 8, I, I, I, ctypes.POINTER(I), I, P)
    lib.zgml_greedy.argtypes = (I, *(P,) * 7, I, I, ctypes.POINTER(I), I, P)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stamp = torch.zeros(17 * 64 * 8, dtype=torch.int64, device=dev)
    dummy = torch.zeros(1, dtype=torch.int8, device=dev)
    for kind, n, k, m, greedy in cases:
        if greedy:
            continue                        # K5 runs K1's M = 1 code: stamp K1
        w = kernel_ab.weight_copies(torch, dev, g, kind, n, k, 1)[0]
        x = torch.randn((m, k), device=dev, generator=g)
        plan, ints = q.i8_args(dev, m, n, k, kind)
        plain = launcher(lib, torch, q, kind, n, k, m, 0, x, ints)
        stamped = launcher(lib, torch, q, kind, n, k, m, 0, x, ints, dummy.data_ptr(),
                           stamp.data_ptr())
        for _ in range(3):
            build.check(plain(w), "qmatmul_i8 (stamped copy)")
        stamp.zero_()
        torch.cuda.synchronize()
        build.check(stamped(w), "qmatmul_i8 (stamped copy)")
        torch.cuda.synchronize()
        s = stamp.view(17, 64, 8).cpu()
        t0 = int(s[0, 63, 0]) or int(s[0, 0, 0])
        us = lambda v: f"{(int(v) - t0) / 1e3:.2f}"
        print(f"== {kind} n={n} k={k} m={m}: S={plan.S} stages={plan.stages} "
              f"self_q={plan.self_q} xg={plan.xg} pis={plan.pis}")
        pro = s[0, 63]
        print("  prologue: " + " ".join(f"{i}={us(pro[i])}" for i in range(4) if int(pro[i])))
        for j in range(63):
            row, prow = s[0, j], s[16, j]
            if not int(row[0]):
                break
            line = " ".join(f"{NAMES[i]}={us(row[i])}" for i in range(7) if int(row[i]))
            if int(prow[7]):
                line += f" {NAMES[7]}={us(prow[7])}"
            print(f"  stage {j}: {line}")
    print(card())


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in ("plans", "stamps"):
        print(__doc__)
        return 2
    cases = json.loads(sys.argv[2]) if len(sys.argv) > 2 else DEFAULT_CASES
    {"plans": plans, "stamps": stamps}[sys.argv[1]](cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
