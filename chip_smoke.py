#!/usr/bin/env python3
"""Chip smoke of zgml_tpu_torch on one CUDA card (built for an H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (nvidia-smi name, power limit), build the CUDA kernels
     from zgml_tpu_torch/csrc with nvcc (one process per source, in
     parallel), print the build time and ptxas' registers and spills of
     the instantiations of the flash kernels, K11, K12, K13, K7, K6, K14,
     K15, K1 and K5 (none of which may spill, but K6's groups of 2 and 4
     rows, recorded);
  2. check each kernel against its plain torch version on the card at the
     shapes of the main paths, and time both (device time from
     torch.profiler, or from CUDA events around calls queued behind a spin
     kernel where the profiler's windows come back empty). At the TinyLlama-1.1B shapes, at Q4_0 and at Q8_0
     where the kernel takes a weight: K2 at M = 1 and 128 on the five
     projections; K1 at M = 1, 4, 8, 32 (the pre-pass's and the kernel's own
     quantized activations bit-equal to the plain ones, two launches
     bit-equal, its rms error against a float64 evaluation of the same int8
     function at most I8_RMS_RATIO x the plain version's, one kernel record
     a call); K5 on lm_head (its id equal to argmax of K1 exactly;
     its error is how far the plain logit of its id lies below the plain
     maximum); K6 at M = 1, 8, 32 (K6d at Q4_0, K6a at Q8_0); K6b at M = 1,
     7, 32; K7 at pos 0, 1, 200, 2047 of a random stacked cache, bf16 and
     int8 (kv8); K3 and K4; K9 on a 128-row chunk at q_offset 0 and 1408 and
     K8 in both its modes (f32 P.V, and p quantized per JAX block under
     ZGML_TPU_ATTN_I8PV) at batch 4 (per-row kv_len 1, 200, 2047, 1000, and
     256, 257, 513, 0 on its 256-key blocks' edges), over a stacked int8
     cache through kv_row, against the plain version of its split plan (the
     I8PV mode within the flips a FLIP_EPS move of the score scale causes),
     two launches bit-equal, with n_split, shared memory, registers and
     spills. At the Llama-2-7B shapes: K2q4, K1q4 and K5q4 on
     its projections; K6c at M = 1, 8 and K6b at M = 1, 7, 32; K7's int8 A
     phase at pos 0, 1, 200, 2047 at Q4_0 and Q8_0, over the bf16 and the
     int8 cache; K3 at head_dim 128 with n_rep 1 (also at q_offset 1408,
     kv_len 1536, where the prefix is split across blocks); K9 as at
     TinyLlama and K8 (both modes) at batch 1 (kv_len 200, 2047). K6c and K7-i8 quantize a
     row they norm
     themselves: the plain version runs on the kernel's own int8 activations,
     and the levels that differ from the plain pre-pass are counted (at most
     one level apart); K7-kv8 likewise runs the plain version on the
     kernel's own quantized q, and its cache row pos must be quantize_columns
     of its own k_cur / v_cur bit for bit. K6 and K7 give the same bits over
     two launches in every case, and record their launch plan (grid, ring
     slots and size, shared memory, row group; ops/decode_plan.py). Each
     case also gets its bound (the
     least time the card could take: bytes moved, each input read once and
     each output written once, over 3.35 TB/s, or the operations over the
     card's peak for their type, f32 at 67 TFLOP/s and int8 at 1979 TOP/s;
     K3 / K9 / K10f and K11, which run each f32 dot as two TF32 products, at
     twice their f32 operations over 495 TFLOP/s, K10dq and K10dkv at the
     TF32 and bf16 MMAs they issue per product; whichever is larger; the
     flash cases and K11 also record their plan's n_split; K10dq and K10dkv
     are bit-equal over two launches and dQ's rms error against float64 is
     at most 2x the plain version's) and, where one PyTorch call
     computes the same function, that call's device time (library_ms, timed
     here and used nowhere in the port; for K8 / K9
     scaled_dot_product_attention after an untimed dequant). At GPT-2 XL's
     heads (Hq = Hkv = 25 of 64, a cache of 1024): K3's bf16 form at
     q_offset 0 / 128 and K4 at kv_len 1, 200, 1023; K4's f32 form
     (decode_attention_f32, f32 K / V) at Whisper large-v3's decoder (20
     heads of 64: the self cache of 448 at kv_len 1, 200, 448, the cross K / V
     of 1500 keys) and at head_dim 128 (library: scaled_dot_product_attention
     f32). K12 (rmsnorm)
     at d 2048 for M = 1, 128, 2048 and at d 4096 for M = 1, 128, within
     1e-6 * max|out|, on its 16-byte vector path, bit-equal over two
     launches (library: torch.nn.functional.rms_norm); K13 (the fused
     elementwise chain) on graph_ffn's chains silu -> mul [512, 5632] and
     add -> sqr [512, 2048], one case per op at [2048, 2048] (library: the
     one PyTorch call of that op) and a bias [2048] added to [2048, 2048]
     (read in place: one kernel a call; library torch.add): bit-equal to
     plain where every step is exact in IEEE f32, else within 1e-6 *
     max|out|; K13's bf16 and f16 forms at the same cases, within
     CHAIN_ULPS_16 ulp per element of plain and bit-equal over two launches
     (library: the op's PyTorch call in that dtype). K7 with its phase E
     (ZGML_TPU_LAYER_FFN) at pos 0, 1, 200, 2047 in four modes (TinyLlama f32
     A phase over the bf16 and the int8 cache, Llama-2-7B int8 A phase over
     both): bit-equal to the chain K7 + K6d (whose time it records) and over
     two launches, within REL_BOUND of its plain version; K6a's no-norm form
     at M = 1, 8, 32; the fused FFN's dx (ops/ffn.FusedFFN) at M = 1, 8, 32
     at both kinds against force_ref() (summary ffn_vjp). The whole-stack
     decode megacalls K14 (stack_decode) and K15 (tape_decode, and
     tape_decode_f32 under ZGML_TPU_TAPE_BF16=0) over a random stacked bf16
     cache and, in their f32-cache modes (stack_decode_f32kv,
     tape_decode_f32kv, tape_decode_f32_f32kv), over a random stacked f32
     cache, at pos 0, 1, 200, 2047: TinyLlama-1.1B's 22 layers, and
     Llama-2-7B's widths over 4 layers; x_out, k_cur and v_cur within
     MEGA_REL_PER_LAYER * L * max|out| with f32 operands and TAPE_BF16_RTOL *
     max|out| with bf16 ones, every layer's cache row pos the kernel's own
     k_cur / v_cur in the cache's dtype; K14 and tape_decode_f32 bit-equal to
     the per-layer chain over the same cache (K7 with the f32 A phase in the
     cache's mode, then K6d at one row, every layer's k_cur / v_cur, the
     final x and the cache), K15's rms distance from the plain version at
     most MEGA_ROUNDING_RATIO x the f32 chain's (so a K15 without its bf16
     roundings fails) and, over the bf16 cache, its rms error against a
     float64 evaluation of the same stack at most MEGA_RMS_RATIO x the plain
     version's; each f32-cache mode, over an f32 cache holding the bf16
     cache's values, bit-equal to its bf16-cache launch (x_out, k_cur,
     v_cur), all six bit-equal over two launches, no spill or stack frame in any instantiation.
     ROADMAP B.6's shapes (check_wide): K1q8's K-split form on a 70B-shaped
     Q8_0 w_down (N 8192, K 28,672) at M = 1 and 32 (within REL_BOUND *
     max|y| of plain, two launches bit-equal, its own int8 activations the
     pre-pass's), and K14 at 80 layers of the 70B width (its pointer table
     read from global memory, 80 table rows over two layers' weights: within
     MEGA_REL_PER_LAYER * 80 * max|out| of plain, bit-equal to the chain and
     over two launches); K5 on K1's K-split plan (q8_greedy_ksplit on that
     w_down, q4_greedy_ksplit on a Q4_0 weight of N 8192, K 51,072): for 8
     rows its id equal to argmax of K1's split output exactly and over two
     launches, its bound K1's split bytes. K4, K8 and K6b also at the
     serving paths' 8 rows.
     The bf16 forms (ZGML_TPU_PREFILL_BF16, the JAX default): K2's at M =
     128 and 512 on every projection of both models at Q4_0 and Q8_0, and
     lm_head's one row at tier_rows 128 (the bf16 GEMV, through the
     dispatch); K3's and K9's at q_offset 0, 128 and 1408 at both models'
     head dims; K10f / K10dq / K10dkv's at the three training cases: the
     pre-pass's bf16(x) bit-equal to torch's, two launches bit-equal, K2
     within K2_BF16_RTOL * max|y|, the flash family within
     max(FLASH_BF16_RTOL * max|o|, FLIP_MARGIN x the plain version's own
     move under a few-ulp move of its score scale) of the plain version of
     the same launch plan (p rounded to bf16 flips where two f32 sums of a
     score differ), rms error against float64 of the same roundings at most
     BF16_RMS_RATIO x the plain version's; bounds at one bf16 product per
     dot, K10's dS products at two TF32; library calls in bf16 (torch.matmul,
     scaled_dot_product_attention, aten's efficient attention);
  3. end to end: synthetic GGUFs from seed 0 (written to .bench_cache/
     once), TinyLlama-1.1B at Q4_0 and Q8_0 and Llama-2-7B at Q4_0 (full
     width and 32 layers, max_seq_len 2048 as bench.py's preset, 4.2 GB) ->
     load_llama(device="cuda") -> LlamaEngine(prefill_chunk=128), on six
     paths, each with the placement counts set to 0 just before it and read
     just after:
     (at the default flags prefill runs the bf16 forms: K2 above 32 rows,
     the prefill head's row, K3, K9 and K10; unfused, kv8_tiny and
     train_rmsnorm_forced pin ZGML_TPU_PREFILL_BF16=0, so the TF32 forms of
     K2q4, K3, K9 and K10 launch too; K2q8's TF32 form is held in phase 2)
       default     TinyLlama Q4_0, the JAX package's default flags: 3 greedy
                   requests (prompts of 7, 128 and 300 tokens, 32 tokens
                   each, reset between) and 1 sampled request (temperature
                   0.8, the engine's seeded generator, prompt 7 tokens, from
                   an engine that prefills in 32-token chunks, so its chunk
                   runs `_layer_step` at <= 32 rows); K1q4, K2q4, K3, K5q4,
                   K6b, K6d and K7 (f32 A phase) must launch;
       unfused     TinyLlama Q4_0, ZGML_TPU_ATTN_BLOCK=0
                   ZGML_TPU_KERNELS_DISABLE=fused_ffn ZGML_TPU_I8DOT=0 (the
                   port's first slice): the 3 greedy requests; K2q4, K3 and
                   K4 must launch;
       q8_default  TinyLlama Q8_0, the default flags: the 3 greedy and the
                   sampled request; K1q8, K2q8, K3, K5q8, K6a and K7 (Q8_0)
                   must launch;
       llama2_7b   Llama-2-7B Q4_0, the default flags (its padded width 4096
                   turns the int8 decode tier on): the 3 greedy and the
                   sampled request; K1q4, K2q4, K3, K5q4, K6b, K6c and K7
                   (int8 A phase) must launch, and no f32-mode K7, K6d or K4;
       kv8_tiny    TinyLlama Q4_0, the default flags, cache_dtype="int8": the
                   3 greedy and the sampled request, then a greedy request of
                   4 rows x 128 prompt tokens (32 tokens each) from a batch-4
                   engine; K1q4, K2q4, K5q4, K6b, K6d, K7 (f32 A phase, int8
                   cache), K9 and K8 must launch, and no K3, K4 or bf16-cache
                   K7;
       kv8_i8pv    kv8_tiny's model and cache at the default flags plus
                   ZGML_TPU_ATTN_I8PV=1: the 3 greedy and the sampled request
                   (K7's int8-cache mode, which the flag does not change),
                   then a greedy request of 4 rows x 320 prompt tokens (3
                   chunks; the decode in K8's second 256-key block) from a
                   batch-4 engine; K8's I8PV mode, kv8_tiny's other kernels
                   with the bf16 forms of K2q4 and K9 must launch, and no
                   f32-p K8 and no TF32 form;
       kv8_7b      Llama-2-7B Q4_0, the default flags, cache_dtype="int8":
                   the 3 greedy and the sampled request and a greedy request
                   of a 1536-token prompt; K1q4, K2q4, K5q4, K6b, K6c, K7
                   (int8 A phase, int8 cache) and K9 must launch, and no K3,
                   K4, K8 or other K7 mode;
       rmsnorm_forced  TinyLlama Q4_0, the default flags plus
                   ZGML_TPU_KERNELS_FORCE=rmsnorm: the 3 greedy and the
                   sampled request; the default path's kernels and K12, which
                   must launch exactly 2 x 22 + 1 times per prefill chunk and
                   once per decode step's head;
       stack_tiny  TinyLlama Q4_0 with ZGML_TPU_STACK_DECODE=1 (the model
                   every TinyLlama Q4_0 path shares carries both megacall
                   views, enable_stacked_decode() and enable_tape_decode(),
                   which the other paths must not take): the 3 greedy and the
                   sampled request; K14 exactly once per decode token, and
                   K1q4, K2q4, K3, K5q4 and K6b, no K7 and no K6d;
       tape_tiny   the same with ZGML_TPU_TAPE_DECODE=1: K15 (bf16 operands)
                   once per decode token;
       stack_tiny_f32kv / tape_tiny_f32kv  stack_tiny's and tape_tiny's
                   first request once more from an engine over the f32 KV
                   cache: the megacall's f32-cache mode once per decode
                   token, K2's, K3's (f32-K/V) bf16 forms and K5q4, against
                   force_ref() as every path's first request;
       layer_ffn_tiny  TinyLlama Q4_0 with ZGML_TPU_LAYER_FFN=1: the 3 greedy
                   and the sampled request; K7 with its phase E exactly once
                   per layer per decode token (22 a token), and K1q4, K2q4,
                   K3, K5q4 and K6b, no K6d and no K7 without E;
       f32kv_tiny  TinyLlama Q4_0 at the default flags over the f32 KV cache
                   (cache_dtype="f32"): the 3 greedy and the sampled request
                   through K3's f32-K/V bf16 form and K7's f32-cache mode
                   (with K1q4, K2q4, K5q4, K6b and K6d); then its 128-token
                   prompt once more under ZGML_TPU_PREFILL_BF16=0 (K2's f32
                   form, K3's f32-K/V f32 form in every layer, counted)
                   against force_ref() within LOGIT_RTOL;
       f32kv_7b    Llama-2-7B Q4_0's first SHALLOW_LAYERS layers over the
                   f32 cache: K7's int8 A phase in its f32-cache mode and K6c;
     then the serving paths (runtime/serving.py, ContinuousBatchingEngine of
     max_batch 8 and prefill_chunk 128 on TinyLlama Q4_0 at the default
     flags): serve_tiny (bf16 cache: K2q4's and K3's bf16 forms prefilling
     into a slot through kv_row, K1q4, K6b and K4 at 8 rows) and
     serve_kv8_tiny (the int8 cache: K9's bf16 form and K8 instead of K3 and
     K4; on the model's first SHALLOW_LAYERS layers), each on 12 greedy
     requests (prompts of 5-300 tokens and 8-48 new
     tokens drawn from seed 0; 8 at the start, 4 after the sixth step, then
     step_burst(8) once admissions drain), with (a) each request's stream
     bit-equal to it served alone by a fresh server, (b) its slot prefill's
     last logits against a batch-1 LlamaEngine prefill (the largest
     difference printed), (c) its tokens equal to the same server's under
     force_ref() up to the first plain top-2 gap under the step bound;
     no other kernel and no plain-tier call may run on a path; on each path
     the first request (and on kv8_tiny and kv8_i8pv the batch-4 one) is compared with the
     same engine under force_ref() (the same path with every kernel swapped
     for its plain version): the prefill logits, one decode step from a
     shared cache, and the greedy tokens (each within a fixed bound or 2 x
     the plain path's own move under a 1e-7 perturbation of the embedding,
     and at prefill where it takes the bf16 forms also of each
     projection's output, the larger). Then two training paths, counted
     the same way (the listed kernels must launch, no other kernel and no
     plain version):
       train_dense      TinyLlama-1.1B width at SHALLOW_LAYERS layers, dense f32 from
                        init_params(seed 0), 6 Adam steps on B 4 x T 512
                        windows of tests/data/corpus_tokens.npy; K10f, K10dq
                        and K10dkv;
       train_q4_frozen  the TinyLlama Q4_0 GGUF with tok_embd and the norms
                        trainable, 6 steps of B 1 x T 512, then the Q8_0 file,
                        2 steps; K2 and K11 at both kinds, and K10;
       train_q4_short   the same models on B 1 x T 32 windows (6 steps at
                        Q4_0, 2 at Q8_0): every call of <= 32 rows, so K1
                        (forward and the fused FFN's backward recompute),
                        K6b and K6a's no-norm form (ops/ffn.FusedFFN), K11
                        at both kinds and K10;
       train_rmsnorm_forced  train_dense's model, 2 more Adam steps under
                        ZGML_TPU_KERNELS_FORCE=rmsnorm: K10 and K12, 45 K12
                        launches per forward (its backward recomputes plain);
     on each: the loss of batch 0 falls from the first step to after the
     last, one step's gradients of every trainable tensor match the same
     step under force_ref() (within max(GRAD_RTOL * max|g|, 2 x the plain
     path's own move under a 1e-7 perturbation of the embedding, and on
     train_rmsnorm_forced also of each norm's output rows, the form K12's
     rounding takes)), and a ZGMT
     checkpoint of the params and Adam state reads back bit-equal (dense and
     Q4_0). Then the graph tier, counted the same way:
       graph_ffn   ComputeGraph of a TinyLlama-1.1B FFN (x [512, 2048],
                   gamma, w_gate / w_up [2048, 5632], w_down [5632, 2048],
                   loss mean(y^2)): its fusion report has the chains
                   silu -> mul and add -> sqr, one run and one
                   value_and_grad launch K13 twice each and nothing else,
                   both agree with force_ref() and fuse=False (1e-5 forward,
                   1e-4 gradients, of max|ref|), 3 SGD steps lower the loss;
       graph_ffn_bf16  graph_ffn's FFN with bf16 vars on the residual stream
                   r = alpha x + a (GRAPH_RES_SCALE): its chain scale -> add
                   is bf16 (K13's bf16 form once per forward), the FFN's two
                   are f32 (the graph's matmul yields f32); r within one bf16
                   ulp of force_ref()'s, loss and gradients within max(2 bf16
                   ulps of max|ref|, 2 x the plain graph's move under one-ulp
                   moves of every chain output) of force_ref() and
                   fuse=False, 3 SGD steps (f32 master weights) lower the
                   loss;
       graph_sub   y - exp(x) and y / exp(x), the chain value as the right
                   operand, through K13 equal fuse=False and numpy;
     and one JAX per-op switch (ROADMAP C.3): TinyLlama Q4_0 under
     ZGML_TPU_KERNELS_DISABLE=attn_block places no K7 and gives the logits
     of ZGML_TPU_ATTN_BLOCK=0 bit for bit. Then the weight forms and the
     text and quality tools, counted the same way:
       mixed_tiny / mixed_kv8_tiny  a TinyLlama-1.1B GGUF that mixes kinds
                   (Q4_0 with attn_v, ffn_up, ffn_down and output.weight at
                   Q8_0 in a pattern over the layers, MIXED_PATHS' comment;
                   the repo's BPE inside): `python -m zgml_tpu_torch
                   inspect` (its census), then `generate --prompt MIXED_TEXT
                   -n 32` through the command line's main on the card over
                   the bf16 cache (K4 in all 22 layers a decode token, no K7)
                   and the int8 cache (K7 in the 11 layers with a fused Q4_0
                   wqkv, K8 at batch 1 in the other 11), K1q8 and K5q8 for
                   the Q8_0 tensors and the head, K6b only where gate|up and
                   down are both Q4_0; each request against force_ref() as
                   the inference paths' first;
       eval_tiny   the perplexity (runtime/eval.py) of EVAL_WINDOWS windows
                   of EVAL_WINDOW tokens of tests/data/corpus_tokens.npy on
                   the TinyLlama Q4_0 and Q8_0 files loaded dense and
                   quantized, and Q4_0 over the int8 cache (K2's and K3's
                   bf16 forms, K9's): each ppl within max(EVAL_RTOL * ppl
                   (1e-5 dense, 1e-3 quantized), 2 x the plain path's own
                   move under 1e-7 perturbations)
                   of force_ref()'s, dppl per pair, wall and device time of
                   one window;
       hf_tiny     a TinyLlama-1.1B-shaped HF safetensors checkpoint in F16
                   (drawn on the card from SEED, written once to
                   .bench_cache/) through load_llama_hf,
                   then LlamaModel.quantize("q8_0") and quantize("q4_0")
                   (timed; packed.quantize equal to the numpy codec on one
                   weight each), dppl against the dense model on eval_tiny's
                   windows, and a greedy request on each quantized model
                   against force_ref() (K7, K6a / K6d, K5q8 / K5q4).
     Then the other models (ROADMAP A.6), each from an F16 HF-named
     checkpoint drawn on the card from SEED and written once to
     .bench_cache/, at the published widths of its config.json:
       gpt2_xl     GPT-2 XL at full width and depth (GPT2_XL) through
                   load_gpt2_hf and LlamaEngine: a 128-token prompt and 32
                   greedy tokens (K3's bf16 form, K4 in every layer; no plain
                   version), against force_ref() as the inference paths'
                   first request; pp128, tg32 and a profile;
       gpt2_xl_f32 its first SHALLOW_LAYERS layers over an f32 cache
                   (GPTModel.init_cache(b, "f32")): the same request through
                   K3's f32-K/V bf16 form and K4's f32 form (counted
                   exactly), against force_ref() likewise; pp128 and tg32 in
                   turns with gpt2_xl;
       whisper_large_v3  Whisper large-v3's shapes (WHISPER_V3, heads from
                   its config.json) through load_whisper_hf: 30 s of tones and
                   noise through log_mel_spectrogram and pad_or_trim(3000),
                   transcribe_greedy (K4's f32 form twice a decoder layer a
                   step, counted exactly); the encoder states and each
                   step's logits within max(1e-5 * max, 2 x the plain path's
                   move under 1e-7 perturbations) of force_ref()'s, the
                   tokens against force_ref()'s and the uncached decoder's;
                   encode ms, decode tok/s, device busy;
     then the parallel paths (zgml_tpu_torch/parallel, ROADMAP A.7a): one
     World of PAR_RANKS = 2 spawned ranks that share the card over gloo
     (NCCL refuses two ranks on one device; every collective goes through
     host memory, counted), each run bounded by PAR_TIMEOUT, a rank that
     fails or hangs failing the smoke; each path's counts are the ranks'
     own, reset just before the counted work and summed over the ranks (each
     rank must launch the path's kernels, no other, no plain version):
       tp2_7b      Llama-2-7B Q4_0 at full width and depth, tensor-parallel
                   over the two ranks (each loads the GGUF on the CPU and
                   keeps its shard on the card): a 128-token prefill and 32
                   greedy tokens through LlamaEngine; K7's int8 A phase, K6c
                   and K1q4 (the gathered head, no K5) on the local shapes,
                   K2q4 and K3 in their bf16 forms; the prefill logits and one
                   decode step from a shared cache (the one-process engine's,
                   each rank its KV heads) against the one-process engine's
                   within max(1e-3 / 1e-2 of max, 2 x the plain path's move
                   under 1e-7 perturbations, PAR_SENS_DRAWS draws each of the
                   embedding and of every projection's output), the tokens
                   equal up to its first top-2 gap under the step bound;
                   and on each rank the same shards under force_ref() (the
                   plain version of every kernel at the local shapes, the
                   same collectives): its prefill logits and one decode step
                   from its own cache within those bounds, its tokens equal
                   to the plain greedy tokens up to their first small top-2
                   gap (against_plain's rule); pp128, tg32, each
                   rank's device-busy share of 8 decode steps and its host
                   copies;
       cp2_tiny    TinyLlama-1.1B Q4_0 on every rank: LlamaEngine.prefill_cp
                   of the 1536-token prompt over a 2-rank 'cp' axis (ring
                   attention: one K10f launch, its bf16 form, a hop that
                   runs, 22 x (1 + 2) in all, and the cp body's K2 bf16),
                   over the bf16 cache, then the int8 cache, each followed
                   by 32 greedy tokens (K7, K6d, K5); the bf16 run's last
                   logits and cache against the chunked prefill's (the
                   logits as tp2_7b's; cache layer 0 one bf16 ulp or 1e-5 of
                   max, all layers within the logits' relative envelope),
                   its tokens up to the first small gap; the int8 run's
                   logits bit-equal to the bf16 run's and its cache the same
                   K/V quantized per position (half a level plus half a bf16
                   ulp), its first decode step and tokens against a
                   one-process int8 engine reading that same cache under
                   force_ref() (the step within the int8 path's
                   plain_envelope step bound, the tokens up to the first
                   small plain top-2 gap); then under
                   ZGML_TPU_PREFILL_BF16=0 (K2's f32 form, K10f's f32-K/V
                   form a hop over the cp body's f32 K/V, as JAX's) the
                   prefill's last logits against the same prefill_cp under
                   force_ref() on the same ranks within LOGIT_RTOL of max;
                   pp1536;
       serve_mesh_tiny  serve_tiny's 12 requests under drive_server over the
                   two ranks at (dp 1, tp 2) and (dp 2, tp 1), on TinyLlama
                   Q4_0's first SHALLOW_LAYERS layers: at dp 2 each
                   stream equal to a one-process server of max_batch 4 (the
                   same function a row at a time), at tp 2 to the one-process
                   server's and to the same sharded server under force_ref()
                   on the ranks (the plain versions at the local shapes), each
                   up to its first top-2 gap under STEP_RTOL; the serving
                   rate;
     and the training half of parallel/ (ROADMAP A.7b) on the same ranks, on
     TinyLlama-1.1B's widths at SHALLOW_LAYERS layers, dense f32 from
     init_params(seed 0), train_dense's batch (B 4 x T 512 corpus windows):
       tp2_train_tiny, dp2_train_tiny, pp2_train_tiny  make_sharded_train_step
                   at tp 2 x dp 1 and dp 2 x tp 1, make_pp_train_step over 2
                   stages (n_micro _choose_micro(4, 2)): 2 SGD steps at lr
                   1e-2; on every rank K10's bf16 forms and no plain version,
                   the losses within 1e-4 relative and the first step's
                   gradients within max(GRAD_RTOL * max|g|, 2 x the
                   one-process gradients' move under 1e-7 embedding
                   perturbations) of the one-process computation on the same
                   inputs (made on the rank), the replicated leaves the same
                   bits on both ranks after the steps; step ms and host
                   copies;
       pp2_tiny    make_pp_forward over 2 stages of the same model at batch
                   2 (n_micro _choose_micro(2, 2) = 2 microbatches of a
                   row, each its own cache row): a 128-token prefill and 32
                   greedy tokens a row, one pipeline forward a token (K3's
                   bf16 form and K4 on each stage's layers, counted exactly,
                   and the stages' run and bubble ticks), against the
                   one-process model
                   (prefill logits within 1e-3, steps within 1e-2 of max,
                   tokens up to a small top-2 gap);
     and NCCL at world size 1 in this process (init, all_reduce and
     all_gather through parallel/mesh.py, equal to their input).
     SHALLOW_PATHS (unfused, q8_default, kv8_i8pv, rmsnorm_forced,
     stack_tiny, tape_tiny, layer_ffn_tiny, serve_kv8_tiny; f32kv_7b on
     Llama-2-7B's), train_dense, train_rmsnorm_forced and the parallel
     training paths run on TinyLlama-1.1B's first SHALLOW_LAYERS = 4
     layers at full width: their kernels run and are checked at full depth
     elsewhere (phase 2 and the full-depth paths). The GGUFs phase 3 loads
     are written by a spawned process while phase 2 runs;
  4. prefill (pp128) and decode (tg32) tokens/s of every path, measured in
     turns (rounds of the paths there and back; median per path), with the
     1536-token prefill (pp1536) and tg32 after it on llama2_7b and kv8_7b,
     and tg32 of the batch-4 engines of kv8_tiny and kv8_i8pv (K8's two
     modes) in turns after the 4 x 320 prompt; each serving path's rate (all
     requests' tokens over the host wall of the whole traffic, median of 3
     runs in turns) and the device-busy share of 8 decode steps of 8 live
     rows;
     per path a torch.profiler breakdown of one prefill chunk and 8 decode
     steps, with the kernels launched per decode token, K7's and K6's and
     the megacall's device time per token (and, on those two, 8 steps at the
     1536-token context; "not measured" where the profiler sees no kernel);
     ms per
     training step and tokens/s of both training paths in turns, and a
     profile of one step each; graph_ffn's ms per run and per
     value_and_grad in turns (median of 6) and a profile of one
     value_and_grad;
  5. the modules without a kernel of their own: the native host codecs
     (built with g++ and loaded, their Q4_0 / Q8_0 bytes of Llama-2-7B's
     layer-0 w_gate_up bit-equal to numpy's, both timed), the packed
     checkpoint (Llama-2-7B written from the loaded model, the packed and
     the GGUF load's host walls, planes and one 128-token prefill's logits
     bit-equal; the 4.2 GB file deleted), the roofline of llama2_7b at
     kv_len 160 over the bf16 cache with the bandwidth measured on the card,
     beside its tg32, and runtime/conformance.py at TinyLlama-1.1B's and
     Llama-2-7B's dims (every entry ok, each entry's kernel call placed on
     cuda with no plain version);
  6. print the kernels' JSON line, then the device JSON line last.
Details also go to chiprun_out/chip_smoke/ (summary JSON with the profiler
tables, and log.txt, every line printed).
There is no CPU path: without a CUDA device it exits 2.
"""
from __future__ import annotations

import contextlib
import json
import math
import multiprocessing
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
# the same at Llama-2-7B (MHA, head_dim 128); its checks of K7 and K3 read a
# stacked cache of 4 layers
GEMM_SHAPES_7B = [("wqkv", 12288, 4096), ("wo", 4096, 4096), ("w_gate_up", 22016, 4096),
                  ("w_down", 4096, 11008), ("lm_head", 32000, 4096)]
L_7B, HQ_7B, HKV_7B, D_7B = 4, 32, 32, 128
FFN_D_7B, FFN_F_7B = 4096, 11008
# the shard shapes a rank of a tp-2 path gives the kernels (phase 2; tp2_7b
# and serve_mesh_tiny's tp 2 run): wqkv and w_gate_up split by heads and by
# gate|up halves, wo and w_down by whole 32-blocks of K, the head by rows;
# the model width stays whole (parallel/tp.py), and every tier verdict is
# taken on these local widths
GEMM_SHAPES_TP2 = [("wqkv", 1280, 2048), ("wo", 2048, 1024), ("w_gate_up", 5632, 2048),
                   ("w_down", 2048, 2816), ("lm_head", 16000, 2048)]
GEMM_SHAPES_7B_TP2 = [("wqkv", 6144, 4096), ("wo", 4096, 2048), ("w_gate_up", 11008, 4096),
                      ("w_down", 4096, 5504), ("lm_head", 16000, 4096)]
# (q_offset, kv_len) of the flash checks: first chunk, second chunk, a
# kv_len that ends inside the chunk; and decode kv_len values
FLASH_CASES = [(0, 128), (128, 256), (128, 200)]
# and at Llama-2-7B also the 12th chunk of the 1536-token prompt that
# llama2_7b's phase-4 rate prefills (the prefix split across blocks)
FLASH_CASES_7B_LONG = [(1408, 1536)]
DECODE_LENS = [1, 200, 2047]
# the int8 cache's checks: K9 on a 128-row chunk at q_offset 0 and 1408 (the
# 12th chunk of a 1536-token prompt); K8 on batches of per-row kv_len
KV8_FLASH_CASES = [(0, 128), (1408, 1536)]
# TinyLlama batch 4, and a batch on K8's JAX-block edges (256 keys at S 2048)
# with a row of no key
KV8_DECODE_LENS = [[1, 200, 2047, 1000], [256, 257, 513, 0],
                   [0, 1, 48, 129, 300, 257, 88, 2047]]     # and the serving paths' 8 rows
# K4 at batch 4 with per-row kv_len (a row with no key gives 0), and at the
# serving paths' 8 rows
DECODE_BATCH_LENS = [0, 1, 200, 2047]
SERVE_DECODE_LENS = KV8_DECODE_LENS[2]
KV8_DECODE_LENS_7B = [[200], [2047]]              # Llama-2-7B, batch 1
LOGIT_RTOL = 1e-3          # kernels vs plain: f32 sums in another order (SENS_MARGIN below)
I8_ROWS = (1, 4, 8, 32)    # K1 cases: decode, kv8_tiny's batch-4 decode, a small batch, the
                           # largest int8 call
# K1's rms error against a float64 evaluation of the same int8 function at
# most this x the plain version's
I8_RMS_RATIO = 2.0
K2_ROWS = (1, 128)         # K2 cases: decode (the GEMV tier), a prefill chunk (tiled)
K2_TRAIN_ROWS = (512,)     # and at TinyLlama-1.1B train_q4_frozen's forward, B 1 x T 512
ATTN_POS = (0, 1, 200, 2047)
FFN_ROWS = (1, 8, 32)      # K6: decode, and calls of <= 32 rows outside it
FFN_I8_ROWS = (1, 8)       # K6c: decode, and a small batch
PLANAR_ROWS = (1, 4, 7, 8, 32)   # K6b: a 1-token chunk, kv8_tiny's batch-4 decode, the
                                 # smoke's 7-token prompt, the serving decode, a full chunk
SAMPLED_CHUNK = 32         # prefill chunk of the sampled request's engine
GREEDY_TRIALS = 8
RATE_ROUNDS = 4            # phase 4: rounds of the paths in turns, there and back
ATTN_LAYER = 3             # K7 reads and writes a layer slab other than the first
REL_BOUND = 1e-5           # K1, K6, K7 vs plain: f32 sums in another order
# K6b (split-TF32 tensor cores, as K2 above 4 rows): its rms error against
# float64 at most this x the plain version's
PLANAR_RMS_RATIO = 2.0
# end to end, a decode step from a shared cache and the greedy-token check's
# gap: the int8 tier (K1's step logits; K6c and K7-i8 on Llama-2-7B, whose
# kernels norm and quantize 64 rows per token summing in another order than
# torch) turns summation-order noise into rounding flips (PERF.md), as the
# bf16 cache does at prefill. The prefill logits are held to
# LOGIT_RTOL * max|logit| and the step to STEP_RTOL * max|logit|, or each to
# SENS_MARGIN times what the plain path itself moves when the embedding rows
# of its tokens are perturbed by SENS_EPS (relative), the larger, over
# SENS_DRAWS draws: a difference within that is one any two faithful
# implementations can show.
STEP_RTOL = 1e-2
SENS_EPS, SENS_DRAWS, SENS_MARGIN = 1e-7, 4, 2.0
PROFILE_TRIES = 3
KINDS = ("q4_0", "q8_0")
# training (phase 2: K10 and K11; phase 3: the two training paths). K10 at
# (label, B, Hq, Hkv, Tq, S, hd, kv_len, q_offset): the TinyLlama training
# shape, Llama-2-7B's heads, and a live prefix shorter than S at an offset
TRAIN_FLASH_CASES = [("TinyLlama B=4 T=512", 4, 32, 4, 512, 512, 64, 512, 0),
                     ("7B hd=128 n_rep=1 T=512", 1, 32, 32, 512, 512, 128, 512, 0),
                     ("kv_len < S", 1, 32, 4, 128, 512, 64, 300, 172)]
# K10's bf16 forms also at the training half of parallel/'s shapes (phase 3,
# PAR_TRAIN): a tp-2 rank's local heads, a dp-2 rank's rows, a pp-2
# microbatch (_choose_micro(4, 2) = 4 of one row)
PAR_TRAIN_FLASH_CASES = [("tp2_train_tiny rank B=4 T=512", 4, 16, 2, 512, 512, 64, 512, 0),
                         ("dp2_train_tiny rank B=2 T=512", 2, 32, 4, 512, 512, 64, 512, 0),
                         ("pp2_train_tiny microbatch B=1 T=512", 1, 32, 4, 512, 512, 64, 512,
                          0)]
TRAIN_M = 512              # K11's rows: B 1 x T 512 (train_q4_frozen), one step's g
K11_RMS_RATIO = 2.0        # K11's rms error vs float64, at most this x cuBLAS f32's
TRAIN_B, TRAIN_T = 4, 512  # train_dense's batch of corpus windows
FROZEN_B = 1               # train_q4_frozen's batch
TRAIN_STEPS = {"train_dense": 6, "train_q4_frozen": 6, "train_q8_frozen": 2,
               "train_rmsnorm_forced": 2, "train_q4_short": 6, "train_q8_short": 2}
SHORT_T = 32               # train_q4_short's windows: B 1 x T 32, the fused FFN's rows
TRAIN_LR = 1e-3
# one step's gradients against force_ref(): per tensor max(GRAD_RTOL * max|g|,
# SENS_MARGIN x the plain path's own move under SENS_EPS embedding
# perturbations); K and V are rounded to bf16, so f32 summation noise flips
# some roundings (PERF.md), as on inference's cache
GRAD_RTOL = 1e-3
GRAD_SENS_DRAWS = 3
TRAIN_RATE_ROUNDS = 3
TRAIN_PATHS = {"train_dense": ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16"),
               "train_q4_frozen": ("q4_matmul_bf16", "q4_matmul_bwd", "flash_fwd_bf16",
                                   "flash_dq_bf16", "flash_dkv_bf16", "q8_matmul_bf16",
                                   "q8_matmul_bwd"),
               "train_rmsnorm_forced": ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm"),
               "train_q4_short": ("q4_matmul_i8", "q8_matmul_i8", "fused_ffn", "fused_ffn_q8",
                                  "q4_matmul_bwd", "q8_matmul_bwd", "flash_fwd_bf16",
                                  "flash_dq_bf16", "flash_dkv_bf16")}
# the flags of a training path that are not an inference path's (set_path)
TRAIN_FLAGS = {"train_rmsnorm_forced": {"ZGML_TPU_KERNELS_FORCE": "rmsnorm",
                                        "ZGML_TPU_PREFILL_BF16": "0"}}
# K12 (phase 2): (M, d) at TinyLlama-1.1B's width (a decode row, a prefill
# chunk, the training batch B 4 x T 512) and at Llama-2-7B's; max-abs error
# against plain within RMSNORM_RTOL * max|out|
RMSNORM_CASES = [(1, 2048), (128, 2048), (2048, 2048), (1, 4096), (128, 4096)]
RMSNORM_RTOL = 1e-6
# K13 (phase 2): the graph_ffn path's two chains at their shapes, one case
# per op at CHAIN_OP_SHAPE, and a bias of CHAIN_OP_SHAPE[1] values added to
# CHAIN_OP_SHAPE (a side read in place); ops exact in IEEE f32 bit-equal to
# plain, the others within CHAIN_RTOL * max|out|
CHAIN_OP_SHAPE = (2048, 2048)
CHAIN_EXACT = {"add", "sub", "mul", "div", "max2", "neg", "recip", "sqr", "sqrt", "abs", "relu",
               "scale", "add_scalar"}
CHAIN_RTOL = 1e-6
# K13's bf16 / f16 forms (phase 2): within this many units in the last place
# of the dtype per element of the plain version
CHAIN_ULPS_16 = 1
# graph_ffn (phase 3): ComputeGraph at TinyLlama-1.1B's FFN width, vars f32
# from seed 0 at std 0.02 (gamma 1 + 0.02 N(0, 1)); forward within
# GRAPH_FWD_RTOL * max|out| and gradients within GRAPH_GRAD_RTOL * max|g| of the
# same graph under force_ref() and with fuse=False; GRAPH_SGD_STEPS of SGD at
# GRAPH_LR must lower the loss
GRAPH_ROWS, GRAPH_D, GRAPH_F, GRAPH_STD = 512, 2048, 5632, 0.02
GRAPH_WRT = ("g", "w_gate", "w_up", "w_down")
GRAPH_CHAINS = [["silu", "mul"], ["add", "sqr"]]
GRAPH_FWD_RTOL, GRAPH_GRAD_RTOL = 1e-5, 1e-4
GRAPH_SGD_STEPS, GRAPH_LR = 3, 1.0
GRAPH_RATE_ROUNDS = 3      # phase 4: run, value_and_grad, value_and_grad, run per round
# graph_ffn_bf16 (phase 3): graph_ffn's FFN with bf16 vars on the residual
# stream r = alpha x + a of a bf16 layer (x the layer's input, a its attention
# half's output; DeepNet's residual scaling, alpha = (2 N)^(1/4) for N = 22
# layers): the chain scale -> add is bf16 (K13's bf16 form), the FFN's two
# chains are f32 (the graph's matmul yields f32, as JAX's
# preferred_element_type does); its chain output within GRAPH_BF16_ULPS bf16
# ulp per element of force_ref()'s, the loss and gradients within max(2 bf16
# ulps of max|ref|, SENS_MARGIN x the plain graph's own move when every chain
# output moves by one ulp of its dtype) of force_ref() and fuse=False
GRAPH_RES_SCALE = (2 * 22) ** 0.25
GRAPH_BF16_CHAINS = [["scale", "add"], ["silu", "mul"], ["add", "sqr"]]
GRAPH_BF16_ULPS = 1
# the megacalls K14 / K15 (phase 2) against their plain versions: with f32
# operands REL_BOUND once per layer (each layer hands its f32 summation-order
# difference on to the next; measured on the H100, PERF.md), with bf16 ones the
# bound of tests/test_torch_tapekernel.py (an operand the two sum in another
# order rounds to either bf16 neighbour)
MEGA_REL_PER_LAYER = REL_BOUND
TAPE_BF16_RTOL = 1e-2
# K15's rms error against a float64 evaluation of the same stack on its bf16
# weights (stackkernel.stacked_decode_f64: operand rows unrounded) at most this
# x the plain version's (the K2 / K11 gate); K14 and tape_decode_f32 are
# bit-equal to the per-layer chain K7 + K6d instead
MEGA_RMS_RATIO = 2.0
# and K15's rms distance from its plain version at most this x that of the f32
# function (the chain, f32 operands) from the same plain version: a K15 without
# its bf16 roundings of the weights and operand rows fails
MEGA_ROUNDING_RATIO = 0.5
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit) for the bound
# ROADMAP B.6's shapes (phase 2, check_wide): a 70B-shaped Q8_0 w_down (N, K), and
# K14 at (L, d, hq, hkv, hd, d_ff, pos) of the 70B width over S
WIDE_DOWN = (8192, 28672)
WIDE_STACK = (80, 8192, 64, 8, 128, 28672, 1500)
WIDE_GREEDY_Q4 = (8192, 51072)   # K5q4's K-split form: Q4_0 rows from K 51,072 (i8_plan)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
I8_OP_PER_S = 1979e12
TF32_FLOP_PER_S = 495e12
# K2's tiled tier, K3 / K9 / K10f and K11 run their f32 dots as two TF32
# products each (x, q, p or g * scale split into hi + lo, csrc/qmatmul.cu,
# csrc/flash_attn.cu, csrc/qmatmul_bwd.cu):
# their least time for the same f32-accurate work counts TF32_PASSES x the f32
# operations at the TF32 rate. K10dq and K10dkv (csrc/flash_bwd.cu) count
# their own products: two TF32 MMAs for a product of an f32 and a bf16
# operand, three for two f32 operands, one bf16 MMA for dK's dP' (both
# operands exact): K10DQ_TF32 and K10DKV_TF32 / K10DKV_BF16 operations per
# (head, live pair, head_dim)
TF32_PASSES = 2
# K3 over f32 K / V (its f32-K/V form, csrc/flash_attn.cu): K and V split as
# q and p are, three TF32 products a dot (hi.hi + lo.hi + hi.lo); held to
# F32KV_RTOL * max|o| of the plain version on the same f32 K / V
F32KV_PASSES = 3
F32KV_RTOL = 1e-5
K10DQ_TF32 = 2 * (2 + 2 + 2)          # S = q K^T, dP = dO V^T, dQ = dS K
K10DKV_TF32 = 2 * (2 + 3 + 3)         # S^T, dV = P^T dO, dK = dS'^T q
K10DKV_BF16 = 2 * 1                   # dP'^T = V bf16(dO)^T
K10_RMS_RATIO = 2.0                   # dQ's rms error vs float64, at most this x plain's
# the bf16 forms (ZGML_TPU_PREFILL_BF16, on by default: JAX's dot_bf16 and the
# flash kernels' bf16 operands), phase 2: K2 at K2_BF16_ROWS on every
# projection at both widths and kinds, and lm_head's one row at tier_rows
# K2_HEAD_TIER (the prefill head: JAX computes the 128-row chunk in bf16);
# K3 / K9 on a 128-row chunk at BF16_FLASH_CASES (q_offset, kv_len); K10 at
# TRAIN_FLASH_CASES. Max-abs error within K2_BF16_RTOL * max|y| (K2: exact
# products of the same bf16 operands, f32 sums in another order); for the
# flash family within max(FLASH_BF16_RTOL * max|o|, FLIP_MARGIN x the plain
# version's own move when its score scale moves by FLIP_EPS): a score one
# ulp off rounds its p to the other bf16 neighbour, which moved o by up to
# 4.4e-4 of max|o| on the H100 (PERF.md), past FLASH_BF16_RTOL alone; rms
# error against a float64 evaluation of the same roundings at most
# BF16_RMS_RATIO x the plain version's (for the flash family, or the flips'
# rms move, the larger)
K2_BF16_ROWS = (128, 512)
K2_HEAD_TIER = 128
BF16_FLASH_CASES = [(0, 128), (128, 256), (1408, 1536)]
K2_BF16_RTOL = 1e-5
FLASH_BF16_RTOL = 1e-4
FLIP_EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -18, -2.0 ** -18)
FLIP_MARGIN = 2.0
BF16_RMS_RATIO = 2.0
# the bf16 forms' products (per head, live pair and head_dim): one bf16 MMA
# per dot; K10's dS products (dQ = dS K, dK = dS'^T q) two TF32 each (dS f32,
# k and bf16(q) exact in TF32)
K10DQ_BF16, K10DQ_BF16_TF32 = 2 * (1 + 1), 2 * 2          # S, dP; dS K
K10DKV_BF16_BF16, K10DKV_BF16_TF32 = 2 * (1 + 1 + 1), 2 * 2   # S^T, dP', dV; dK
LIBRARY_K2_BF16 = ("torch.matmul(x, W.T) in bf16 (cuBLAS, bf16 out), x and the dequantized W "
                   "rounded to bf16 outside the timed window")
SWITCH_STEPS = 4           # decode steps of the kernel-switch check (phase 3)
# the JAX flags of each path (config.py); a missing key is unset, i.e. default
# (unfused and kv8_tiny pin ZGML_TPU_PREFILL_BF16=0, so the TF32 forms of K2q4,
# K3 and K9 launch on a path; train_rmsnorm_forced pins it for K10's;
# kv8_i8pv is the default flags plus ZGML_TPU_ATTN_I8PV=1)
PATHS = {"default": {},
         "unfused": {"ZGML_TPU_ATTN_BLOCK": "0", "ZGML_TPU_KERNELS_DISABLE": "fused_ffn",
                     "ZGML_TPU_I8DOT": "0", "ZGML_TPU_PREFILL_BF16": "0"},
         "q8_default": {},
         "llama2_7b": {},
         "kv8_tiny": {"ZGML_TPU_PREFILL_BF16": "0"},
         "kv8_i8pv": {"ZGML_TPU_ATTN_I8PV": "1"},
         "kv8_7b": {},
         "rmsnorm_forced": {"ZGML_TPU_KERNELS_FORCE": "rmsnorm"},
         "stack_tiny": {"ZGML_TPU_STACK_DECODE": "1"},
         "tape_tiny": {"ZGML_TPU_TAPE_DECODE": "1"},
         "layer_ffn_tiny": {"ZGML_TPU_LAYER_FFN": "1"},
         "f32kv_tiny": {},
         "f32kv_7b": {}}
PATH_MODEL = {"default": ("tinyllama-1.1b", "q4_0"), "unfused": ("tinyllama-1.1b", "q4_0"),
              "q8_default": ("tinyllama-1.1b", "q8_0"), "llama2_7b": ("llama2-7b", "q4_0"),
              "kv8_tiny": ("tinyllama-1.1b", "q4_0"), "kv8_i8pv": ("tinyllama-1.1b", "q4_0"),
              "kv8_7b": ("llama2-7b", "q4_0"),
              "rmsnorm_forced": ("tinyllama-1.1b", "q4_0"),
              "stack_tiny": ("tinyllama-1.1b", "q4_0"), "tape_tiny": ("tinyllama-1.1b", "q4_0"),
              "layer_ffn_tiny": ("tinyllama-1.1b", "q4_0"),
              "f32kv_tiny": ("tinyllama-1.1b", "q4_0"), "f32kv_7b": ("llama2-7b", "q4_0")}
# the megacall of a path, which must launch exactly once per decode token
MEGA_PATHS = {"stack_tiny": "stack_decode", "tape_tiny": "tape_decode"}
# the layer kernel of a path, which must launch once per layer per decode token
LAYER_PATHS = {"layer_ffn_tiny": "attn_block_ffn"}
# the engines' cache_dtype; else bf16
PATH_CACHE = {"kv8_tiny": "int8", "kv8_i8pv": "int8", "kv8_7b": "int8", "f32kv_tiny": "f32",
              "f32kv_7b": "f32"}
# paths that also answer the sampled request
PATH_SAMPLED = ("default", "q8_default", "llama2_7b", "kv8_tiny", "kv8_i8pv", "kv8_7b",
                "rmsnorm_forced", "stack_tiny", "tape_tiny", "layer_ffn_tiny", "f32kv_tiny",
                "f32kv_7b")
# + a greedy request of 4 rows x this many prompt tokens (32 new tokens each)
# from a batch-4 engine (K8; on kv8_i8pv 3 chunks of 128, the decode in JAX
# block 1 of K8's 256-key blocks)
BATCH4_PATHS = {"kv8_tiny": 128, "kv8_i8pv": 320}
LONG_PATHS = ("kv8_7b",)        # + a LONG_PROMPT-token prompt, 32 new tokens
LONG_RATE_PATHS = ("llama2_7b", "kv8_7b")   # phase 4: tg32 also at a LONG_PROMPT context
LONG_PROMPT = 1536
# paths whose decode quantizes per token beyond K1 (K7-i8 and K6c on Llama-2-7B, the
# int8 cache, K15's bf16 operands): their tokens are compared up to a top-2 gap
# under the step bound
FLIP_PATHS = ("llama2_7b", "kv8_tiny", "kv8_i8pv", "kv8_7b", "tape_tiny", "f32kv_7b",
              "mixed_tiny",
              "mixed_kv8_tiny")
PATH_KERNELS = {"default": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                            "q4_greedy", "fused_ffn_norm", "fused_ffn", "attn_block"),
                "unfused": ("q4_matmul", "flash_attention", "decode_attention"),
                "q8_default": ("q8_matmul_i8", "q8_matmul_bf16", "flash_attention_bf16",
                               "q8_greedy", "fused_ffn_norm_q8", "attn_block_q8"),
                "llama2_7b": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                              "q4_greedy", "fused_ffn_norm_i8", "fused_ffn", "attn_block_i8"),
                "kv8_tiny": ("q4_matmul_i8", "q4_matmul", "flash_attention_q8", "q4_greedy",
                             "fused_ffn_norm", "fused_ffn", "attn_block_kv8",
                             "decode_attention_q8"),
                "kv8_i8pv": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_q8_bf16",
                             "q4_greedy", "fused_ffn_norm", "fused_ffn", "attn_block_kv8",
                             "decode_attention_q8_i8pv"),
                "kv8_7b": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_q8_bf16",
                           "q4_greedy", "fused_ffn_norm_i8", "fused_ffn", "attn_block_i8_kv8"),
                "rmsnorm_forced": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                                   "q4_greedy", "fused_ffn_norm", "fused_ffn", "attn_block",
                                   "rmsnorm"),
                "stack_tiny": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                               "q4_greedy", "fused_ffn", "stack_decode"),
                "tape_tiny": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                              "q4_greedy", "fused_ffn", "tape_decode"),
                "layer_ffn_tiny": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                                   "q4_greedy", "fused_ffn", "attn_block_ffn"),
                # the f32 KV cache: K3's f32-K/V bf16 form for the prefill
                # (F32KV_TINY_F32 below: its f32 form), K7's f32-cache mode
                "f32kv_tiny": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16_f32kv",
                               "q4_greedy", "fused_ffn_norm", "fused_ffn", "attn_block_f32kv"),
                "f32kv_7b": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16_f32kv",
                             "q4_greedy", "fused_ffn_norm_i8", "fused_ffn",
                             "attn_block_i8_f32kv")}
# stack_tiny's and tape_tiny's first request served once more over the f32
# KV cache (its own counts: label, the megacall's f32-cache mode), and the
# kernels that request must launch beside it: the prefill chunk's K2 and K3
# (f32-K/V) bf16 forms, the prefill head's bf16 GEMV row and K5 for the
# greedy decode heads
MEGA_F32_PATHS = {"stack_tiny": ("stack_tiny_f32kv", "stack_decode_f32kv"),
                  "tape_tiny": ("tape_tiny_f32kv", "tape_decode_f32kv")}
MEGA_F32_KERNELS = ("q4_matmul_bf16", "flash_attention_bf16_f32kv", "q4_greedy")
# the modules phase (5): the packed file's prompt, the roofline's live
# context (a 128-token prefill and 32 decode tokens, as tg32's) and the
# conformance sweep's models
PACKED_PROMPT = 128
ROOFLINE_KV = 160
CONFORMANCE_MODELS = ("tinyllama-1.1b", "llama2-7b")
# f32kv_tiny's second prefill (its 128-token prompt) under
# ZGML_TPU_PREFILL_BF16=0: K2's f32 form and K3's f32-K/V f32 form
F32KV_TINY_F32 = ("f32kv_tiny_f32", {"ZGML_TPU_PREFILL_BF16": "0"},
                  ("q4_matmul", "flash_attention_f32kv"))
# continuous batching (runtime/serving.py) on the TinyLlama Q4_0 model the
# default path loads, at the default flags: its cache and the kernels that
# must launch (and no other, no plain version)
SERVE_PATHS = {"serve_tiny": ("bf16", ("q4_matmul_i8", "q4_matmul_bf16",
                                       "flash_attention_bf16", "fused_ffn",
                                       "decode_attention")),
               "serve_kv8_tiny": ("int8", ("q4_matmul_i8", "q4_matmul_bf16",
                                           "flash_attention_q8_bf16", "fused_ffn",
                                           "decode_attention_q8"))}
SERVE_BATCH, SERVE_CHUNK = 8, 128     # max_batch, prefill_chunk
SERVE_REQUESTS, SERVE_FIRST = 12, 8   # requests, of which submitted at the start
SERVE_ADMIT_STEP = 6                  # the rest after this many steps
SERVE_BURST = 8                       # step_burst(n) once admissions drain
SERVE_PROMPT, SERVE_NEW = (5, 300), (8, 48)   # prompt lengths, max_new_tokens (inclusive)
SERVE_RATE_RUNS = 3                   # phase 4: serving rate, median of runs in turns
# the parallel paths (phase 3): PAR_RANKS spawned ranks share the card over gloo
# (NCCL refuses two ranks on one device); each World.run of a path is bounded
# by PAR_TIMEOUT seconds. tp2_7b: a PAR_PROMPT-token prefill in PAR_CHUNK-row
# chunks and PAR_NEW greedy tokens; cp2_tiny: LONG_PROMPT tokens, then PAR_NEW;
# the plain path's envelope from PAR_SENS_DRAWS draws a perturbation kind
PAR_RANKS, PAR_TIMEOUT = 2, 300
PAR_PROMPT, PAR_NEW, PAR_CHUNK, PAR_SENS_DRAWS = 128, 32, 128, 2
# the kernels each rank of a parallel path must launch (and no other, no plain
# version): JAX's verdicts on the local shapes (tp2_7b: K7's int8 A phase and K6c
# at the padded width 4096, which TP keeps; K1 for the gathered head, never K5);
# cp2_tiny's prefill is the cp body (K2's bf16 form over 768-row chunks, K10f's
# bf16 form a ring hop), its decode the normal batch-1 path (K7, K6d, K5; the
# first step returns its logits: K1 for its head)
PAR_KERNELS = {"tp2_7b": ("q4_matmul_i8", "q4_matmul_bf16", "flash_attention_bf16",
                          "fused_ffn_norm_i8", "attn_block_i8"),
               "cp2_tiny_bf16": ("q4_matmul_bf16", "flash_fwd_bf16", "attn_block",
                                 "fused_ffn_norm", "q4_greedy", "q4_matmul_i8"),
               "cp2_tiny_int8": ("q4_matmul_bf16", "flash_fwd_bf16", "attn_block_kv8",
                                 "fused_ffn_norm", "q4_greedy", "q4_matmul_i8"),
               # ZGML_TPU_PREFILL_BF16=0, the prefill alone: K2's f32 form
               # (and its GEMV for the head's row), K10f's f32-K/V form
               "cp2_tiny_f32": ("q4_matmul", "flash_fwd_f32kv"),
               "serve_mesh_tiny": SERVE_PATHS["serve_tiny"][1]}
# the training half of parallel/ (phase 3, on the same PAR_RANKS ranks):
# TinyLlama-1.1B widths at SHALLOW_LAYERS layers, dense f32 from
# init_params(seed SEED), TRAIN_B x TRAIN_T corpus windows (train_dense's
# batch; the loss on tokens[:, :-1] against tokens[:, 1:]), PAR_TRAIN_STEPS
# SGD steps at PAR_TRAIN_LR, each path's mesh; every rank launches K10's bf16
# forms and no plain version. Each is held on every rank to the one-process
# computation on the same inputs (made on the rank): the loss of each step
# within PAR_LOSS_RTOL relative, the first step's gradients per tensor
# within max(GRAD_RTOL * max|g|, SENS_MARGIN x the one-process gradients'
# own move under SENS_EPS embedding perturbations, GRAD_SENS_DRAWS draws),
# the replicated leaves the same bits on both ranks after the steps
PAR_TRAIN = {"tp2_train_tiny": dict(tp=2, dp=1), "dp2_train_tiny": dict(tp=1, dp=2),
             "pp2_train_tiny": dict(pp=2)}
PAR_TRAIN_KERNELS = ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")
PAR_TRAIN_STEPS, PAR_TRAIN_LR, PAR_LOSS_RTOL = 2, 1e-2, 1e-4
# pp2_tiny: make_pp_forward over 2 stages of the same dense model at batch
# PP_FWD_BATCH (n_micro _choose_micro(PP_FWD_BATCH, 2) microbatches, which
# write and read their own rows of the stage's cache), a PAR_PROMPT-token
# prefill and PAR_NEW greedy tokens a row, one pipeline forward a token: K3's
# bf16 form and K4 on each stage's layers, once a microbatch
PP_FWD_KERNELS = ("flash_attention_bf16", "decode_attention")
PP_FWD_BATCH = 2
# TinyLlama paths whose kernels other paths (and phase 2) launch and check at
# full depth: driven on the model's first SHALLOW_LAYERS layers (full width);
# so are train_dense / train_rmsnorm_forced (K10 at full depth: train_q4_*,
# phase 2), serve_mesh_tiny (serve_tiny's kernels) and serve_kv8_tiny (K9's
# bf16 form and K8 run at full depth in kv8_tiny, K1, K2 and K6b in serve_tiny)
SHALLOW_PATHS, SHALLOW_LAYERS = ("unfused", "q8_default", "kv8_i8pv", "rmsnorm_forced",
                                 "stack_tiny", "tape_tiny", "layer_ffn_tiny",
                                 "serve_kv8_tiny", "f32kv_7b"), 4
# the GGUFs phase 3 loads, written by a spawned process while phase 2 runs
# (which draws its own weights), joined within GGUF_TIMEOUT seconds
GGUF_FILES = (("tinyllama-1.1b", "q4_0"), ("tinyllama-1.1b", "q8_0"), ("llama2-7b", "q4_0"))
GGUF_TIMEOUT = 600
# the weight forms and quality tools (phase 3): mixed_tiny's GGUF is TinyLlama-1.1B
# at Q4_0 with attn_v at Q8_0 in even layers (q / k / v load unfused), ffn_up at
# Q8_0 in layers 1 mod 4 (gate / up unfused), ffn_down at Q8_0 in layers 3 mod 4
# (a Q4_0 gate|up beside a Q8_0 down: the FFN composed) and output.weight at
# Q8_0 (mixed_kinds), with the repo's BPE (tests/data/bpe) inside; the prompt is
# text. Its kernels over each cache (the composed FFNs' K1 projections quantize
# swiglu(gate, up): FLIP_PATHS' token rule)
MIXED_TEXT = "The port runs the quantized llama path on the card, one kernel at a time."
MIXED_PATHS = {"mixed_tiny": ("bf16", ("q4_matmul_i8", "q8_matmul_i8", "q4_matmul_bf16",
                                       "q8_matmul_bf16", "flash_attention_bf16",
                                       "decode_attention", "fused_ffn", "q8_greedy")),
               "mixed_kv8_tiny": ("int8", ("q4_matmul_i8", "q8_matmul_i8", "q4_matmul_bf16",
                                           "q8_matmul_bf16", "flash_attention_q8_bf16",
                                           "decode_attention_q8", "attn_block_kv8",
                                           "fused_ffn", "q8_greedy"))}
# eval_tiny / hf_tiny: perplexity of the first EVAL_WINDOWS windows of EVAL_WINDOW
# tokens of tests/data/corpus_tokens.npy; each card ppl within max(EVAL_RTOL *
# ppl, SENS_MARGIN x the plain path's own move under SENS_EPS perturbations,
# EVAL_SENS_DRAWS draws) of force_ref()'s. EVAL_RTOL is the CPU tests' bound on
# the port's ppl against JAX's (tests/test_torch_eval.py): f32 sums in another
# order for a dense model; for the quantized tiers and the int8 cache the bf16
# and int8 roundings of such sums flip, and the 1e-7 perturbations move the
# plain path less than the kernels do there (the int8 cache's ppl sat 1.1e-4
# from force_ref()'s at a 2x envelope of 6.7e-5 on the H100, PERF.md)
EVAL_WINDOW, EVAL_WINDOWS = 256, 16
EVAL_RTOL = {False: 1e-5, True: 1e-3}          # by quantized
EVAL_SENS_DRAWS = 2
EVAL_KERNELS = ("q4_matmul_bf16", "q8_matmul_bf16", "flash_attention_bf16",
                "flash_attention_q8_bf16")
HF_KERNELS = ("q4_matmul_bf16", "q8_matmul_bf16", "flash_attention_bf16", "attn_block",
              "attn_block_q8", "fused_ffn_norm", "fused_ffn_norm_q8", "q4_greedy", "q8_greedy")
# GPT-2 XL and Whisper large-v3 (phase 2's shapes and phase 3's gpt2_xl /
# whisper_large_v3 paths): the widths and depths of the published config.json
# of openai-community/gpt2-xl (n_embd 1600, n_head 25, n_layer 48, n_ctx 1024,
# vocab 50257) and openai/whisper-large-v3 (num_mel_bins 128,
# max_source_positions 1500, d_model 1280, 20 heads, 32 + 32 layers, vocab
# 51866, max_target_positions 448); random weights at WEIGHT_STD from SEED in
# HF-named F16 safetensors written on the card (not downloaded)
GPT2_XL = dict(vocab_size=50257, d_model=1600, n_heads=25, n_layers=48, max_seq_len=1024)
WHISPER_V3 = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_heads=20,
                  n_audio_layers=32, vocab_size=51866, n_text_ctx=448, n_text_state=1280,
                  n_text_heads=20, n_text_layers=32)
GPT_PROMPT, GPT_NEW = 128, 32          # gpt2_xl: one 128-token chunk, 32 greedy tokens
GPT_KERNELS = ("flash_attention_bf16", "decode_attention")
# gpt2_xl_f32: the same model's first SHALLOW_LAYERS layers over an f32 cache
# (GPTModel.init_cache(b, "f32")): K3's f32-K/V bf16 form, K4's f32 form
GPT_F32_KERNELS = ("flash_attention_bf16_f32kv", "decode_attention_f32")
# phase 2 at GPT-2 XL's heads (Hq = Hkv = 25 of 64, a cache of n_ctx 1024):
# K4 at these kv_len, K3's bf16 form on a 128-row chunk at (q_offset, kv_len)
GPT_DECODE_LENS = [1, 200, 1023]
GPT_FLASH_CASES = [(0, 128), (128, 256)]
# K4's f32 form (phase 2): (label, Hq, Hkv, hd, S, kv_len) at Whisper
# large-v3's decoder (its self cache of n_text_ctx positions, its cross K / V
# over n_audio_ctx keys: not a multiple of the 32-key group) and at head_dim 128
F32_DECODE_CASES = [("self", 20, 20, 64, 448, 1), ("self", 20, 20, 64, 448, 200),
                    ("self", 20, 20, 64, 448, 448), ("cross", 20, 20, 64, 1500, 1500),
                    ("hd=128 n_rep=4", 32, 8, 128, 1500, 1500)]
# whisper_large_v3: 30 s of tones plus noise from SEED through the log-mel
# frontend and pad_or_trim(WHISPER_FRAMES), transcribe_greedy from the
# multilingual model's <|startoftranscript|> to <|endoftext|> or
# WHISPER_TOKENS tokens; the encoder states and each step's logits against
# force_ref() within max(WHISPER_RTOL * max, SENS_MARGIN x the plain path's
# own move under SENS_EPS perturbations of its input, WHISPER_SENS_DRAWS draws)
WHISPER_SECONDS, WHISPER_FRAMES = 30, 3000
WHISPER_BOS, WHISPER_EOS, WHISPER_TOKENS = 50258, 50257, 32
WHISPER_TONES = (220.0, 440.0, 1250.0, 3100.0)
WHISPER_RTOL = 1e-5
WHISPER_SENS_DRAWS = 2
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
    "attn_block_i8": ("attn_block_i8", _CSRC + "layer_attn.cu",
                      "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_q8": ("attn_block_i8_q8", _CSRC + "layer_attn.cu",
                         "zgml_tpu/ops/layerkernel.py:685"),
    "fused_ffn_norm_i8": ("fused_ffn_norm_i8", _CSRC + "ffn.cu", "zgml_tpu/ops/ffn.py:416"),
    "fused_ffn": ("fused_ffn", _CSRC + "ffn_planar.cu", "zgml_tpu/ops/ffn.py:224"),
    "flash_attention_q8": ("flash_attention_q8", _CSRC + "flash_attn.cu",
                           "zgml_tpu/ops/attention.py:702"),
    "decode_attention_q8": ("decode_attention_q8", _CSRC + "decode_attn.cu",
                            "zgml_tpu/ops/attention.py:506"),
    "decode_attention_q8_i8pv": ("decode_attention_q8_i8pv", _CSRC + "decode_attn.cu",
                                 "zgml_tpu/ops/attention.py:506"),
    "attn_block_kv8": ("attn_block_kv8", _CSRC + "layer_attn.cu",
                       "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_kv8_q8": ("attn_block_kv8_q8", _CSRC + "layer_attn.cu",
                          "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_kv8": ("attn_block_i8_kv8", _CSRC + "layer_attn.cu",
                          "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_kv8_q8": ("attn_block_i8_kv8_q8", _CSRC + "layer_attn.cu",
                             "zgml_tpu/ops/layerkernel.py:685"),
    "flash_fwd": ("flash_fwd", _CSRC + "flash_attn.cu", "zgml_tpu/ops/flash_vjp.py:140"),
    "flash_dq": ("flash_dq", _CSRC + "flash_bwd.cu", "zgml_tpu/ops/flash_vjp.py:230"),
    "flash_dkv": ("flash_dkv", _CSRC + "flash_bwd.cu", "zgml_tpu/ops/flash_vjp.py:327"),
    "q4_matmul_bwd": ("qmatmul_bwd", _CSRC + "qmatmul_bwd.cu", "zgml_tpu/ops/qmatmul.py:593"),
    "q8_matmul_bwd": ("qmatmul_bwd_q8", _CSRC + "qmatmul_bwd.cu",
                      "zgml_tpu/ops/qmatmul.py:541"),
    "rmsnorm": ("rmsnorm", _CSRC + "rmsnorm.cu", "zgml_tpu/ops/rmsnorm.py:37"),
    "fused_chain": ("fused_chain", _CSRC + "elementwise.cu", "zgml_tpu/ops/elementwise.py:104"),
    "stack_decode": ("stack_decode", _CSRC + "stack_decode.cu", "zgml_tpu/ops/stackkernel.py:422"),
    "tape_decode": ("tape_decode", _CSRC + "stack_decode.cu", "zgml_tpu/ops/tapekernel.py:553"),
    "q4_matmul_bf16": ("qmatmul_bf16", _CSRC + "qmatmul.cu", "zgml_tpu/ops/qmatmul.py:141"),
    "q8_matmul_bf16": ("qmatmul_bf16_q8", _CSRC + "qmatmul.cu", "zgml_tpu/ops/qmatmul.py:81"),
    "flash_attention_bf16": ("attention_bf16", _CSRC + "flash_attn.cu",
                             "zgml_tpu/ops/attention.py:194"),
    "flash_attention_q8_bf16": ("flash_attention_q8_bf16", _CSRC + "flash_attn.cu",
                                "zgml_tpu/ops/attention.py:702"),
    "flash_fwd_bf16": ("flash_fwd_bf16", _CSRC + "flash_attn.cu",
                       "zgml_tpu/ops/flash_vjp.py:140"),
    "flash_dq_bf16": ("flash_dq_bf16", _CSRC + "flash_bwd.cu", "zgml_tpu/ops/flash_vjp.py:230"),
    "flash_dkv_bf16": ("flash_dkv_bf16", _CSRC + "flash_bwd.cu", "zgml_tpu/ops/flash_vjp.py:327"),
    "tape_decode_f32": ("tape_decode_f32", _CSRC + "stack_decode.cu",
                        "zgml_tpu/ops/tapekernel.py:553"),
    "attn_block_ffn": ("attn_block_ffn", _CSRC + "layer_attn_ffn.cu",
                       "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_kv8_ffn": ("attn_block_kv8_ffn", _CSRC + "layer_attn_ffn.cu",
                           "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_ffn": ("attn_block_i8_ffn", _CSRC + "layer_attn_ffn.cu",
                          "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_kv8_ffn": ("attn_block_i8_kv8_ffn", _CSRC + "layer_attn_ffn.cu",
                              "zgml_tpu/ops/layerkernel.py:685"),
    "fused_ffn_q8": ("fused_ffn_q8", _CSRC + "ffn.cu", "zgml_tpu/ops/ffn.py:100"),
    "fused_chain_bf16": ("fused_chain_bf16", _CSRC + "elementwise.cu",
                         "zgml_tpu/ops/elementwise.py:104"),
    "fused_chain_f16": ("fused_chain_f16", _CSRC + "elementwise.cu",
                        "zgml_tpu/ops/elementwise.py:104"),
    "decode_attention_f32": ("decode_attention_f32", _CSRC + "decode_attn.cu",
                             "zgml_tpu/ops/attention.py:375"),
    "flash_fwd_f32kv": ("flash_fwd_f32kv", _CSRC + "flash_attn.cu",
                        "zgml_tpu/ops/flash_vjp.py:140"),
    # the f32 KV cache: K3 over f32 K / V in both forms, K7 over the f32 cache
    "flash_attention_f32kv": ("attention_f32kv", _CSRC + "flash_attn.cu",
                              "zgml_tpu/ops/attention.py:194"),
    "flash_attention_bf16_f32kv": ("attention_bf16_f32kv", _CSRC + "flash_attn.cu",
                                   "zgml_tpu/ops/attention.py:194"),
    "attn_block_f32kv": ("attn_block_f32kv", _CSRC + "layer_attn_f32.cu",
                         "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_f32kv_q8": ("attn_block_f32kv_q8", _CSRC + "layer_attn_f32.cu",
                            "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_f32kv": ("attn_block_i8_f32kv", _CSRC + "layer_attn_f32.cu",
                            "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_f32kv_ffn": ("attn_block_f32kv_ffn", _CSRC + "layer_attn_f32.cu",
                             "zgml_tpu/ops/layerkernel.py:685"),
    "attn_block_i8_f32kv_ffn": ("attn_block_i8_f32kv_ffn", _CSRC + "layer_attn_f32.cu",
                                "zgml_tpu/ops/layerkernel.py:685"),
    # the megacalls over the f32 cache, K5 on K1's K-split plan
    "stack_decode_f32kv": ("stack_decode_f32kv", _CSRC + "stack_decode_f32.cu",
                           "zgml_tpu/ops/stackkernel.py:422"),
    "tape_decode_f32kv": ("tape_decode_f32kv", _CSRC + "stack_decode_f32.cu",
                          "zgml_tpu/ops/tapekernel.py:553"),
    "tape_decode_f32_f32kv": ("tape_decode_f32_f32kv", _CSRC + "stack_decode_f32.cu",
                              "zgml_tpu/ops/tapekernel.py:553"),
    "q4_greedy_ksplit": ("qmatmul_greedy_ksplit", _CSRC + "qmatmul_i8.cu",
                         "zgml_tpu/ops/qmatmul.py:462"),
    "q8_greedy_ksplit": ("qmatmul_greedy_ksplit_q8", _CSRC + "qmatmul_i8.cu",
                         "zgml_tpu/ops/qmatmul.py:444"),
}
# the form of each kernel with two (ZGML_TPU_PREFILL_BF16; K8's
# ZGML_TPU_ATTN_I8PV): its mode in the JSON line, beside the counter that
# names it
MODE = {**{k: "tf32" for k in ("q4_matmul", "q8_matmul", "flash_attention", "flash_attention_q8",
                               "flash_fwd", "flash_dq", "flash_dkv")},
        **{k: "bf16" for k in ("q4_matmul_bf16", "q8_matmul_bf16", "flash_attention_bf16",
                               "flash_attention_q8_bf16", "flash_fwd_bf16", "flash_dq_bf16",
                               "flash_dkv_bf16")},
        "decode_attention_q8": "f32p", "decode_attention_q8_i8pv": "i8pv",
        **{k: "phase_e" for k in ("attn_block_ffn", "attn_block_kv8_ffn", "attn_block_i8_ffn",
                                  "attn_block_i8_kv8_ffn")},
        "fused_ffn_q8": "no_norm", "fused_chain": "f32", "fused_chain_bf16": "bf16",
        "fused_chain_f16": "f16", "decode_attention_f32": "f32", "flash_fwd_f32kv": "f32kv",
        "flash_attention_f32kv": "f32kv", "flash_attention_bf16_f32kv": "bf16_f32kv",
        **{k: "f32_cache" for k in ("attn_block_f32kv", "attn_block_f32kv_q8",
                                    "attn_block_i8_f32kv")},
        **{k: "phase_e_f32_cache" for k in ("attn_block_f32kv_ffn", "attn_block_i8_f32kv_ffn")},
        "stack_decode_f32kv": "f32_cache", "tape_decode_f32kv": "bf16_f32_cache",
        "tape_decode_f32_f32kv": "f32_f32_cache", "q4_greedy_ksplit": "k_split",
        "q8_greedy_ksplit": "k_split"}
# kernel name of each (kernel family, kind) checked in phase 2
NAME = {("matmul", "q4_0"): "q4_matmul", ("matmul", "q8_0"): "q8_matmul",
        ("i8", "q4_0"): "q4_matmul_i8", ("i8", "q8_0"): "q8_matmul_i8",
        ("greedy", "q4_0"): "q4_greedy", ("greedy", "q8_0"): "q8_greedy",
        ("ffn", "q4_0"): "fused_ffn_norm", ("ffn", "q8_0"): "fused_ffn_norm_q8",
        ("attn", "q4_0"): "attn_block", ("attn", "q8_0"): "attn_block_q8",
        ("attn_i8", "q4_0"): "attn_block_i8", ("attn_i8", "q8_0"): "attn_block_i8_q8",
        ("attn_kv8", "q4_0"): "attn_block_kv8", ("attn_kv8", "q8_0"): "attn_block_kv8_q8",
        ("attn_i8_kv8", "q4_0"): "attn_block_i8_kv8",
        ("attn_i8_kv8", "q8_0"): "attn_block_i8_kv8_q8",
        ("attn_f32kv", "q4_0"): "attn_block_f32kv", ("attn_f32kv", "q8_0"): "attn_block_f32kv_q8",
        ("attn_i8_f32kv", "q4_0"): "attn_block_i8_f32kv",
        ("attn_i8_f32kv", "q8_0"): "attn_block_i8_f32kv_q8"}
# K2's library call (phase 2): the same function, timed and used nowhere in the port
LIBRARY_K2 = ("torch.matmul(x, W.T) f32 (allow_tf32 False), W dequantized outside the "
              "timed window")
# why a kernel has no library_ms
NO_LIBRARY = {
    "q8": "none: no PyTorch call computes a 32-block Q8_0 product (torch._weight_int8pack_mm "
          "takes one scale per output channel, not per 32-block)",
    "q4_i8": "none: no PyTorch call quantizes x to int8 per 32-block before a Q4_0 product "
             "(torch._weight_int4pack_mm rounds x to bf16: another function, kept as "
             "int4pack_ms)",
    "greedy": "none: no single PyTorch call computes the quantized GEMV and its argmax",
    "ffn": "none: no single PyTorch call computes rmsnorm + quantized gate|up + SwiGLU + down "
           "+ residual",
    "planar": "none: no single PyTorch call computes quantized gate|up + SwiGLU + down",
    "attn": "none: no single PyTorch call computes the fused attention half-layer "
            "(rmsnorm, quantized QKV, RoPE, attention, wo, residual, cache write)",
    "chain": "none: no single PyTorch call computes an arbitrary elementwise chain given as "
             "data (torch.compile would generate one; it is not a library call)",
    "attn_ffn": "none: no single PyTorch call computes a whole decode layer (rmsnorm, "
                "quantized QKV, RoPE, attention, cache write, wo, residual, rmsnorm, quantized "
                "SwiGLU FFN, residual)",
    "stack": "none: no single PyTorch call computes a whole decode stack (every layer's norms, "
             "quantized projections, RoPE, attention, cache write, SwiGLU and residuals)",
}


def log(msg: str):
    """Print a line, and keep it in OUT_DIR/log.txt (a long run's console
    may keep only its tail)."""
    print(msg, flush=True)
    if OUT_DIR.is_dir():
        with open(OUT_DIR / "log.txt", "a") as f:
            f.write(msg + "\n")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(build_log: pathlib.Path, pattern: str) -> list[dict]:
    """Registers, shared memory, stack and spills of each kernel entry in
    nvcc's build log (ptxas -v) whose mangled name contains `pattern`."""
    import re
    out, cur = [], None
    for line in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(entry=m.group(1)) if pattern in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def time_ms(torch, calls, iters: int) -> tuple[float, float, str]:
    """(device ms, host-inclusive ms, timer) per call over `iters` calls,
    cycling through `calls` (several weight copies keep the L2 cache cold,
    as in a real step). Device ms is the sum of the calls' kernel durations
    from torch.profiler (CUPTI; timer "profiler"), or, where no profiler
    window saw a kernel, CUDA-event time over a backlog (`held_event_ms`;
    timer "events"); host-inclusive ms is CUDA-event time over the loop,
    which includes the Python wrapper when it is slower than the kernels."""
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
    # idempotent, so the window is profiled again. A window also loses some
    # of its kernel records (a few launches in 50 of K7, and now and then most
    # of them), so the time per call is each kernel's mean duration times its
    # launches per call, not the window's sum over `iters`
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.count]
        if kern:
            per_call = sum(_self_device_us(ev) / ev.count * max(1, round(ev.count / iters))
                           for ev in kern)
            return per_call / 1e3, host_ms, "profiler"
    # a run of empty windows (seen once on the H100, at the first library call
    # of phase 2): the profiler gives no time here, CUDA events do
    log(f"  (the profiler saw no kernel in {PROFILE_TRIES} windows: CUDA events)")
    return held_event_ms(torch, calls, iters, host_ms), host_ms, "events"


_SPIN_CYCLES_PER_MS = []


def held_event_ms(torch, calls, iters: int, host_ms: float) -> float:
    """Device ms per call from one pair of CUDA events around `iters` calls
    queued behind a spin kernel that holds the stream until the host has
    queued them all, so the span is the card's time for the calls and not
    the host's time to issue them (up to the launch queue's depth)."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    hold_ms = min(2000.0, 2.0 * host_ms * iters + 5.0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * _SPIN_CYCLES_PER_MS[0]))
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _self_device_us(ev) -> float:
    v = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if v is None else v


def require(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def bound_of(nbytes: float, flops: float, i8ops: float = 0, bf16ops: float = 0,
             tf32ops: float = 0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `nbytes` and do `flops` f32 (CUDA cores), `i8ops` int8, `bf16ops`
    bf16 and `tf32ops` TF32 (tensor cores) operations."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (flops / F32_FLOP_PER_S + i8ops / I8_OP_PER_S + bf16ops / BF16_FLOP_PER_S
          + tf32ops / TF32_FLOP_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def stream_plan(plan) -> dict:
    """The launch of a weight-streaming decode kernel (K6, K7) as a case
    records it: one block an SM, the ring's slots and size, the dynamic shared
    memory, the row group."""
    return dict(grid=plan.grid, stages=plan.stages, slot_bytes=plan.slot_bytes,
                smem_bytes=plan.smem_bytes, mr=plan.mr)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_kernels(torch, dev, ptxas_q8):
    """Phase 2; ptxas_q8: ptxas' report of K8's instantiations (recorded in
    its cases)."""
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_ref,
                                              flash_attention_cuda, flash_attention_ref)
    from zgml_tpu_torch.ops.ffn import (fused_ffn_cuda, fused_ffn_norm_cuda,
                                        fused_ffn_norm_ref, fused_ffn_ref)
    from zgml_tpu_torch.ops.decode_plan import attn_ffn_plan, attn_plan, ffn_plan, launch_args
    from zgml_tpu_torch.ops.layerkernel import (attn_block_cuda, attn_block_ffn_ref,
                                                attn_block_ref, qkv_ref)
    from zgml_tpu_torch.quant.kv_cache import quantize_columns
    from zgml_tpu_torch.ops.qmatmul import (GEMV_MAX_M, _fwd_card, greedy_cuda, greedy_ref,
                                            i8_plan, qmatmul_cuda, qmatmul_i8_cuda,
                                            qmatmul_i8_ref, qmatmul_plan, qmatmul_ref,
                                            quantize_act_cuda, quantize_act_ref,
                                            rmsnorm_quantize_ref)
    from zgml_tpu_torch.quant.packed import PackedWeight

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {name: [] for name in KERNELS}

    def record(kernel, case, err, bound, t, tp, nbytes, flops, lib=None, lib_note=None,
               i8ops=0, bf16ops=0, tf32ops=0, **extra):
        """One case: error, device times, the bound from this case's bytes
        and operations (all operation counts 0: the bytes bound alone), and
        the library call's time or why there is none."""
        b_ms, b_by = bound_of(nbytes, flops, i8ops, bf16ops, tf32ops)
        lib_ms = None if lib is None else lib[0]
        timers = {"ms": t[2], "plain_ms": tp[2]} | ({} if lib is None else {"library_ms": lib[2]})
        results[kernel].append(dict(case=case, err=err, bound=bound, ms=t[0], call_ms=t[1],
                                    plain_ms=tp[0], plain_call_ms=tp[1], bytes=nbytes,
                                    flops=flops, i8ops=i8ops, bf16ops=bf16ops,
                                    tf32ops=tf32ops, bound_ms=b_ms,
                                    bound_by=b_by,
                                    library_ms=lib_ms, library_note=lib_note, timers=timers,
                                    **extra))
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

    def own_levels(act, x, gamma):
        """How many of a kernel's int8 activations differ from the plain
        pre-pass of the same rows (the two norms sum in another order); no
        level may be more than one apart."""
        rq, _ = rmsnorm_quantize_ref(x, gamma, 1e-5)
        diff = (act[0].reshape(rq.shape).to(torch.int16) - rq.to(torch.int16)).abs()
        require(int(diff.max()) <= 1, f"int8 activations {int(diff.max())} levels from plain")
        return int((diff > 0).sum()), diff.numel()

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

    def check_projection(kind, name, n, k, model, k2_rows=None, i8_rows=I8_ROWS, greedy=True):
        """K2 at K2_ROWS (and K2_TRAIN_ROWS at TinyLlama-1.1B) or k2_rows, K1
        at i8_rows and, on lm_head where greedy, K5. K2: two launches give the same bits; its
        rms error against float64 is recorded, and above GEMV_MAX_M rows
        (split-TF32 tensor cores) held to at most K11_RMS_RATIO x the plain
        version's (cuBLAS f32); the bound counts the tiled tier's TF32
        products (TF32_PASSES per f32 product), the GEMV's f32 ones. The
        library call is torch.matmul(x, W.T) in f32 on the weight dequantized
        outside the timed window (the same function); at Q4_0 the int4pack
        call, which rounds x to bf16 (another function), is a second note."""
        copies = weights(kind, n, k)
        w = copies[0]
        wbytes = nbytes_of(w.qs, w.d)
        packs, refusal = int4pack(copies) if kind == "q4_0" else (None, None)
        kname = NAME["matmul", kind]
        wds = [c.dequant() for c in copies[:copies_for(n * k * 4, most=len(copies))]]
        for m in K2_ROWS + (K2_TRAIN_ROWS if not model else ()) if k2_rows is None else k2_rows:
            x = torch.randn((m, k), device=dev, generator=g)
            got, again, want = qmatmul_cuda(x, w), qmatmul_cuda(x, w), qmatmul_ref(x, w)
            torch.cuda.synchronize()
            case = f"{model}{name} M={m} N={n} K={k}"
            err = float((got - want).abs().max())
            bound = 1e-4 * k ** 0.5 + 1e-5 * float(want.abs().max())
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
            exact = x.double() @ wds[0].double().T
            rms, rms_plain = (float((y.double() - exact).square().mean().sqrt())
                              for y in (got, want))
            del exact
            tiled = m > GEMV_MAX_M
            require(not tiled or rms <= K11_RMS_RATIO * rms_plain,
                    f"{kname} {case}: rms error vs float64 {rms:.3g} > {K11_RMS_RATIO} x "
                    f"plain's {rms_plain:.3g}")
            t = time_ms(torch, [lambda w_=c: qmatmul_cuda(x, w_) for c in copies], 50)
            tp = time_ms(torch, [lambda w_=c: qmatmul_ref(x, w_) for c in copies], 20)
            lib = time_ms(torch, [lambda wd_=wd: torch.matmul(x, wd_.T) for wd in wds], 20)
            extra = dict(rms_vs_plain=rms / rms_plain if rms_plain else None)
            if kind == "q4_0":
                i4, i4_note = time_int4(packs, x, want) if packs is not None else (None, refusal)
                extra.update(int4pack_ms=None if i4 is None else i4[0],
                             int4pack_note=f"another function: {i4_note}")
            if tiled:
                extra["n_split"] = qmatmul_plan(m, n, k, *_fwd_card(dev.index or 0, kind)).n_split
            record(kname, case, err, bound, t, tp, m * k * 4 + wbytes + m * n * 4,
                   0 if tiled else 2 * m * n * k, lib, LIBRARY_K2,
                   tf32ops=TF32_PASSES * 2 * m * n * k if tiled else 0, **extra)
        del wds
        wd64 = w.dequant().double()
        for m in i8_rows:
            x = torch.randn((m, k), device=dev, generator=g)
            xq, xs = quantize_act_cuda(x)
            rq, rs = quantize_act_ref(x)
            act = (torch.empty_like(rq), torch.empty_like(rs))
            got, want = qmatmul_i8_cuda(x, w, act_out=act), qmatmul_i8_ref(x, w)
            again = qmatmul_i8_cuda(x, w)
            torch.cuda.synchronize()
            kname = NAME["i8", kind]
            case = f"{model}{name} M={m}"
            require(torch.equal(xq, rq)
                    and torch.equal(xs.view(torch.int32), rs.view(torch.int32)),
                    f"{kname} {case}: the pre-pass's activations differ from plain")
            require(torch.equal(act[0], rq)
                    and torch.equal(act[1].view(torch.int32), rs.view(torch.int32)),
                    f"{kname} {case}: the kernel's own activations differ from plain")
            err, bound = rel_err(got, want)
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
            # the same int8 function in float64: x's own levels and scales, exact weights
            exact = ((rq.double().view(m, -1, 32) * rs.double()[..., None]).view(m, k)
                     @ wd64.T)
            rms, rms_plain = (float((y.double() - exact).square().mean().sqrt())
                              for y in (got, want))
            del exact
            require(rms <= I8_RMS_RATIO * rms_plain,
                    f"{kname} {case}: rms error vs float64 {rms:.3g} > {I8_RMS_RATIO} x "
                    f"plain's {rms_plain:.3g}")
            per_call = kernels_per_call(torch, lambda: qmatmul_i8_cuda(x, w))
            require(per_call is None or len(per_call) == 1,
                    f"{kname} {case}: more than one kernel a call: {per_call}")
            t = time_ms(torch, [lambda w_=c: qmatmul_i8_cuda(x, w_) for c in copies], 50)
            tp = time_ms(torch, [lambda w_=c: qmatmul_i8_ref(x, w_) for c in copies], 10)
            plan = i8_plan(m, n, k, kind, torch.cuda.get_device_properties(dev).
                           multi_processor_count)
            extra = dict(rms_vs_plain=rms / rms_plain if rms_plain else None,
                         kernels_per_call="not measured" if per_call is None else per_call,
                         plan=dict(tr=plan.tr, S=plan.S, stages=plan.stages,
                                   slot_bytes=plan.slot_bytes, self_q=plan.self_q, xg=plan.xg,
                                   pis=plan.pis, smem_bytes=plan.smem_bytes))
            if kind == "q4_0":    # int4pack rounds x to bf16: another function, a note
                i4, i4_note = time_int4(packs, x, qmatmul_ref(x, w)) if packs is not None \
                    else (None, refusal)
                extra.update(int4pack_ms=None if i4 is None else i4[0],
                             int4pack_note=f"another function: {i4_note}")
            record(kname, f"{model}{name} M={m} N={n} K={k}", err, bound, t, tp,
                   m * k * 4 + wbytes + m * n * 4, 0, None,
                   NO_LIBRARY["q8" if kind == "q8_0" else "q4_i8"], i8ops=2 * m * n * k,
                   **extra)
        del wd64
        if name == "lm_head" and greedy:
            check_greedy(torch, dev, g, kind, copies, record, greedy_cuda, greedy_ref,
                         qmatmul_i8_cuda, qmatmul_i8_ref, model)

    def ffn_weights(kind, d, f):
        gus, wds = weights(kind, 2 * f, d, 96_000_000), weights(kind, d, f, 48_000_000)
        return list(zip(gus, wds)), nbytes_of(gus[0].qs, gus[0].d, wds[0].qs, wds[0].d)

    def check_ffn(kind, d, f, model, a_i8):
        """K6d / K6a (a_i8 False) or K6c at the FFN shape: M = 1 (decode) and
        the larger calls of <= 32 rows."""
        pairs, wbytes = ffn_weights(kind, d, f)
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        kname = "fused_ffn_norm_i8" if a_i8 else NAME["ffn", kind]
        for m in FFN_I8_ROWS if a_i8 else FFN_ROWS:
            x = torch.randn((1, m, d), device=dev, generator=g)
            act = ((torch.empty((m, d), dtype=torch.int8, device=dev),
                    torch.empty((m, d // 32), device=dev)) if a_i8 else None)
            got = fused_ffn_norm_cuda(x, gamma, *pairs[0], 1e-5, a_i8, act)
            again = fused_ffn_norm_cuda(x, gamma, *pairs[0], 1e-5, a_i8)
            want = fused_ffn_norm_ref(x, gamma, *pairs[0], 1e-5, a_i8, act)
            torch.cuda.synchronize()
            err, bound = rel_err(got, want)
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{kname} {model}M={m}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"{kname} {model}M={m}: two launches differ")
            case, extra = f"{model}M={m} D={d} F={f}", stream_plan(
                launch_args(dev, ffn_plan, m, d, f, kind, a_i8)[0])
            if a_i8:
                n_diff, n_all = own_levels(act, x, gamma)
                case += f", on the kernel's int8 activations ({n_diff} of {n_all} levels " \
                        f"one off the plain pre-pass)"
                extra.update(levels_off=n_diff, levels=n_all)
            t = time_ms(torch, [lambda p_=pr: fused_ffn_norm_cuda(x, gamma, *p_, 1e-5, a_i8)
                                for pr in pairs], 50 if m == 1 else 10)
            tp = time_ms(torch, [lambda p_=pr: fused_ffn_norm_ref(x, gamma, *p_, 1e-5, a_i8)
                                 for pr in pairs], 20 if m == 1 else 10)
            ops = 2 * m * 3 * d * f
            record(kname, case, err, bound, t, tp, 2 * m * d * 4 + d * 4 + wbytes,
                   ops // 3 if a_i8 else ops, None, NO_LIBRARY["ffn"],
                   i8ops=2 * ops // 3 if a_i8 else 0, **extra)

    def check_planar(d, f, model, rows=PLANAR_ROWS):
        """K6b on normed rows (PLANAR_ROWS: a 1-token chunk, kv8_tiny's
        batch-4 decode, the smoke's 7-token prompt in a <= 32-row chunk, a
        full 32-row chunk; or `rows`).
        Within REL_BOUND * max|y| of plain, two launches bit-equal, its rms
        error against float64 at most PLANAR_RMS_RATIO x the plain
        version's; the bound counts the tensor-core form's TF32 products
        (TF32_PASSES per f32 product), the CUDA-core form's (M <=
        PLANAR_F32_MAX_M) f32 FMAs."""
        from zgml_tpu_torch.ops.decode_plan import planar_args
        from zgml_tpu_torch.ops.ffn import PLANAR_F32_MAX_M
        pairs, wbytes = ffn_weights("q4_0", d, f)
        gu0, wd0 = (w.dequant().double() for w in pairs[0])
        for m in rows:
            h = torch.randn((1, m, d), device=dev, generator=g)
            got, again = fused_ffn_cuda(h, *pairs[0]), fused_ffn_cuda(h, *pairs[0])
            want = fused_ffn_ref(h, *pairs[0])
            torch.cuda.synchronize()
            err, bound = rel_err(got, want)
            case = f"{model}M={m} D={d} F={f}"
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"fused_ffn {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"fused_ffn {case}: two launches differ")
            gu_ = h.double() @ gu0.T
            act = torch.nn.functional.silu(gu_[..., :f]) * gu_[..., f:]
            exact = act @ wd0.T
            rms, rms_plain = (float((y.double() - exact).square().mean().sqrt())
                              for y in (got, want))
            require(rms <= PLANAR_RMS_RATIO * rms_plain,
                    f"fused_ffn {case}: rms error vs float64 {rms:.3g} > {PLANAR_RMS_RATIO} x "
                    f"plain's {rms_plain:.3g}")
            plan = (planar_args(dev, m, d, f)[0] if m > PLANAR_F32_MAX_M
                    else launch_args(dev, ffn_plan, m, d, f, "q4_0", False)[0])
            t = time_ms(torch, [lambda p_=pr: fused_ffn_cuda(h, *p_) for pr in pairs],
                        50 if m <= 4 else 20)
            tp = time_ms(torch, [lambda p_=pr: fused_ffn_ref(h, *p_) for pr in pairs], 10)
            tensor = m > PLANAR_F32_MAX_M          # else the CUDA-core form's f32 FMAs
            record("fused_ffn", case, err, bound, t, tp, 2 * m * d * 4 + wbytes,
                   0 if tensor else 6 * m * d * f, None, NO_LIBRARY["planar"],
                   tf32ops=TF32_PASSES * 6 * m * d * f if tensor else 0,
                   rms_vs_plain=rms / rms_plain if rms_plain else None,
                   form="tensor cores" if tensor else "CUDA cores", grid=plan.grid,
                   stages=plan.stages, slot_bytes=plan.slot_bytes, smem_bytes=plan.smem_bytes,
                   **(dict(kc=plan.kc, ks=plan.ks) if tensor else dict(mr=plan.mr)))
        del gu0, wd0

    def random_cache(shape, kv8):
        """A random stacked cache [L, 1, Hkv, S, hd]: bf16, f32 (kv8 "f32"), or
        (kv8 True) int8 levels with per-position f32 scales (the dequantized
        values ~1)."""
        if kv8 == "f32":
            return torch.randn(shape, device=dev, generator=g)
        if not kv8:
            return torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        return (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g),
                torch.rand(shape[:-1], device=dev, generator=g) * 0.01 + 0.01)

    def clone(c):
        return tuple(t.clone() for t in c) if isinstance(c, tuple) else c.clone()

    def check_attn_block(kind, shape, model, a_i8, kv8=False, d=None):
        """K7 over a random stacked cache, layer ATTN_LAYER; with a_i8 its
        int8 A phase, held to the plain version on the kernel's own int8
        activations; with kv8 its int8-cache mode, held to the plain version
        on the kernel's own quantized q (q8_out), its row pos bit-equal to
        quantize_columns of its own k_cur / v_cur; with kv8 "f32" over the
        f32 cache, its row pos bit-equal to its own k_cur / v_cur. The model
        width d is hq * hd unless given (a tensor-parallel shard: local
        heads, whole width)."""
        f32kv = kv8 == "f32"
        kv8 = kv8 is True
        n_layers, hq, hkv, hd = shape
        kc = random_cache((n_layers, 1, hkv, S, hd), "f32" if f32kv else kv8)
        vc = random_cache((n_layers, 1, hkv, S, hd), "f32" if f32kv else kv8)
        d, nq, nkv = d or hq * hd, hq * hd, hkv * hd
        nqkv = nq + 2 * nkv
        wqkvs, wos = weights(kind, nqkv, d, 64_000_000), weights(kind, d, nq, 64_000_000)
        layers = list(zip(wqkvs, wos))
        wbytes = nbytes_of(wqkvs[0].qs, wqkvs[0].d, wos[0].qs, wos[0].d)
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        kname = NAME[("attn_i8" if a_i8 else "attn") + ("_kv8" if kv8 else "")
                     + ("_f32kv" if f32kv else ""), kind]
        # K and V of one position
        row_bytes = 2 * (nkv + 4 * hkv) if kv8 else 2 * nkv * (4 if f32kv else 2)
        cache_form = 2 if f32kv else kv8
        for pos in ATTN_POS:
            x = torch.randn((1, 1, d), device=dev, generator=g)
            cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=dev), hd)
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            kr, vr = clone(kc), clone(vc)
            act = ((torch.empty(d, dtype=torch.int8, device=dev),
                    torch.empty(d // 32, device=dev)) if a_i8 else None)
            q8 = ((torch.empty((hq, hd), dtype=torch.int8, device=dev),
                   torch.empty(hq, device=dev)) if kv8 else None)
            got = attn_block_cuda(x, gamma, *layers[0], kc, vc, ATTN_LAYER, pos_t, cos, sin,
                                  hq, hkv, 1e-5, a_i8, act, q8)
            # the second launch reads the rows below pos and writes row pos again
            again = attn_block_cuda(x, gamma, *layers[0], kc, vc, ATTN_LAYER, pos_t, cos, sin,
                                    hq, hkv, 1e-5, a_i8)
            want = attn_block_ref(x, gamma, *layers[0], kr, vr, ATTN_LAYER, pos, cos, sin,
                                  hq, hkv, 1e-5, a_i8, act, q8)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{kname} {model}pos={pos}: two launches differ")
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            require(all(bool(torch.isfinite(a).all()) for a in got)
                    and all(e <= b for e, b in errs),
                    f"{kname} {model}pos={pos}: (max_abs_err, bound) of x_out, k_cur, v_cur "
                    f"{errs}")
            rows = torch.arange(S, device=dev) != pos
            if kv8:
                same = True
                for (lv, sc), (lv_r, sc_r), cur in ((kc, kr, got[1]), (vc, vr, got[2])):
                    wq, ws = quantize_columns(cur[0, :, 0])
                    same &= (torch.equal(lv[ATTN_LAYER, 0, :, pos], wq)
                             and torch.equal(sc[ATTN_LAYER, 0, :, pos].view(torch.int32),
                                             ws.view(torch.int32))
                             and torch.equal(lv[..., rows, :], lv_r[..., rows, :])
                             and torch.equal(sc[..., rows], sc_r[..., rows]))
                require(same, f"{kname} {model}pos={pos}: cache row pos is not "
                        f"quantize_columns(k_cur, v_cur), or another row changed")
            else:
                require(torch.equal(kc[ATTN_LAYER, 0, :, pos], got[1][0, :, 0].to(kc.dtype))
                        and torch.equal(vc[ATTN_LAYER, 0, :, pos], got[2][0, :, 0].to(vc.dtype))
                        and torch.equal(kc[..., rows, :], kr[..., rows, :])
                        and torch.equal(vc[..., rows, :], vr[..., rows, :]),
                        f"{kname} {model}pos={pos}: cache row pos is not (k_cur, v_cur) in the "
                        f"cache's {kc.dtype}, or another row changed")
            case = f"{model}pos={pos} layer={ATTN_LAYER} (x_out, k_cur, v_cur)"
            extra = stream_plan(launch_args(dev, attn_plan, d, hq, hkv, hd, kind, a_i8,
                                            cache_form, S)[0])
            if a_i8:
                n_diff, n_all = own_levels(act, x, gamma)
                case += f", on the kernel's int8 activations ({n_diff} of {n_all} levels " \
                        f"one off the plain pre-pass)"
                extra.update(levels_off=n_diff, levels=n_all)
            if kv8:
                q_plain = qkv_ref(x, gamma, layers[0][0], cos, sin, hq, hkv, hd, 1e-5, a_i8,
                                  act)[0]
                rq, _ = quantize_columns(q_plain.reshape(hq, hd))
                dq = (q8[0].to(torch.int16) - rq.to(torch.int16)).abs()
                require(int(dq.max()) <= 1, f"{kname} {model}pos={pos}: the kernel's q levels "
                        f"are {int(dq.max())} from the plain quantization")
                case += f", on the kernel's quantized q ({int((dq > 0).sum())} of {dq.numel()} " \
                        f"levels one off the plain quantization)"
                extra.update(q_levels_off=int((dq > 0).sum()), q_levels=dq.numel())
            t = time_ms(torch, [lambda l_=ly: attn_block_cuda(x, gamma, *l_, kc, vc, ATTN_LAYER,
                                                              pos_t, cos, sin, hq, hkv, 1e-5,
                                                              a_i8) for ly in layers], 50)
            tp = time_ms(torch, [lambda l_=ly: attn_block_ref(x, gamma, *l_, kc, vc, ATTN_LAYER,
                                                              pos, cos, sin, hq, hkv, 1e-5,
                                                              a_i8) for ly in layers], 20)
            worst = max(errs, key=lambda eb: eb[0] / eb[1])
            # x, gamma, the weights, cos/sin and the pos cache rows in; x_out,
            # k_cur/v_cur and the new cache row out
            nbytes = (2 * d * 4 + wbytes + hd * 4 + pos * row_bytes
                      + d * 4 + 2 * nkv * 4 + row_bytes)
            qkv_ops = 2 * d * nqkv
            attn_ops = 2 * hq * pos * hd                # q . k, and again p . v
            flops = ((0 if a_i8 else qkv_ops) + 2 * nq * d + (1 if kv8 else 2) * attn_ops
                     + 4 * hq * hd)
            i8ops = (qkv_ops if a_i8 else 0) + (attn_ops if kv8 else 0)
            record(kname, case, worst[0], worst[1], t, tp, nbytes, flops, None,
                   NO_LIBRARY["attn"], i8ops=i8ops, **extra)

    def check_attn_block_ffn(shape, f, model, a_i8, kv8):
        """K7 with its phase E (ZGML_TPU_LAYER_FFN, Q4_0) over a random
        stacked cache, layer ATTN_LAYER, at ATTN_POS: bit-equal to the chain
        K7 (the same A phase and cache) then K6d at one row, in x_out, k_cur,
        v_cur and the cache, and over two launches; within REL_BOUND of its
        plain version (attn_block_ffn_ref on the kernel's own int8
        activations and quantized q, as K7's checks). The chain's device time
        is recorded beside it (chain_ms); the bound is K7's bytes and
        operations plus K6d's weights and operations. kv8 "f32": over the
        f32 cache."""
        f32kv = kv8 == "f32"
        kv8 = kv8 is True
        n_layers, hq, hkv, hd = shape
        kc = random_cache((n_layers, 1, hkv, S, hd), "f32" if f32kv else kv8)
        vc = random_cache((n_layers, 1, hkv, S, hd), "f32" if f32kv else kv8)
        d, nq, nkv = hq * hd, hq * hd, hkv * hd
        nqkv = nq + 2 * nkv
        layers = list(zip(weights("q4_0", nqkv, d, 64_000_000), weights("q4_0", d, nq, 64_000_000),
                          weights("q4_0", 2 * f, d, 96_000_000), weights("q4_0", d, f, 48_000_000)))
        wbytes = sum(nbytes_of(w.qs, w.d) for w in layers[0])
        g1 = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        g2 = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        kname = ("attn_block" + ("_i8" if a_i8 else "") + ("_kv8" if kv8 else "")
                 + ("_f32kv" if f32kv else "") + "_ffn")
        row_bytes = 2 * (nkv + 4 * hkv) if kv8 else 2 * nkv * (4 if f32kv else 2)

        def run(ly, kc_, vc_, pos_t, cos, sin, act=None, q8=None):
            return attn_block_cuda(x, g1, ly[0], ly[1], kc_, vc_, ATTN_LAYER, pos_t, cos, sin,
                                   hq, hkv, 1e-5, a_i8, act, q8, ffn=(g2, ly[2], ly[3]))

        def chain(ly, kc_, vc_, pos_t, cos, sin):
            x2 = attn_block_cuda(x, g1, ly[0], ly[1], kc_, vc_, ATTN_LAYER, pos_t, cos, sin,
                                 hq, hkv, 1e-5, a_i8)
            return (fused_ffn_norm_cuda(x2[0], g2, ly[2], ly[3], 1e-5, False), *x2[1:])
        for pos in ATTN_POS:
            x = torch.randn((1, 1, d), device=dev, generator=g)
            cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=dev), hd)
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            k1, v1, k2, v2, kr, vr = (clone(c) for c in (kc, vc, kc, vc, kc, vc))
            act = ((torch.empty(d, dtype=torch.int8, device=dev),
                    torch.empty(d // 32, device=dev)) if a_i8 else None)
            q8 = ((torch.empty((hq, hd), dtype=torch.int8, device=dev),
                   torch.empty(hq, device=dev)) if kv8 else None)
            got = run(layers[0], kc, vc, pos_t, cos, sin, act, q8)
            again = run(layers[0], k1, v1, pos_t, cos, sin)
            want_chain = chain(layers[0], k2, v2, pos_t, cos, sin)
            want = attn_block_ffn_ref(x, g1, layers[0][0], layers[0][1], kr, vr, ATTN_LAYER, pos,
                                      cos, sin, hq, hkv, 1e-5, (g2, *layers[0][2:]), a_i8, act,
                                      q8)
            torch.cuda.synchronize()
            same = lambda a, b: (all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
                                 if isinstance(a, tuple) else torch.equal(a, b))
            require(all(torch.equal(a, b) and torch.equal(a, c)
                        for a, b, c in zip(got, want_chain, again))
                    and same(kc, k1) and same(vc, v1) and same(kc, k2) and same(vc, v2),
                    f"{kname} {model}pos={pos}: not bit-equal to the chain K7 + K6d, or two "
                    f"launches differ")
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            require(all(bool(torch.isfinite(a).all()) for a in got)
                    and all(e <= b for e, b in errs),
                    f"{kname} {model}pos={pos}: (max_abs_err, bound) of x_out, k_cur, v_cur "
                    f"vs plain {errs}")
            if f32kv:            # the row K7 writes: k_cur / v_cur as they are
                require(torch.equal(kc[ATTN_LAYER, 0, :, pos], got[1][0, :, 0])
                        and torch.equal(vc[ATTN_LAYER, 0, :, pos], got[2][0, :, 0]),
                        f"{kname} {model}pos={pos}: the f32 cache's row pos is not k_cur / v_cur")
            plan = launch_args(dev, attn_ffn_plan, d, hq, hkv, hd, "q4_0", a_i8,
                               2 if f32kv else kv8, S, f)[0]
            t = time_ms(torch, [lambda l_=ly: run(l_, kc, vc, pos_t, cos, sin)
                                for ly in layers], 50)
            tc = time_ms(torch, [lambda l_=ly: chain(l_, kc, vc, pos_t, cos, sin)
                                 for ly in layers], 50)
            tp = time_ms(torch, [lambda l_=ly: attn_block_ffn_ref(
                x, g1, l_[0], l_[1], kc, vc, ATTN_LAYER, pos, cos, sin, hq, hkv, 1e-5,
                (g2, *l_[2:]), a_i8) for ly in layers], 20)
            worst = max(errs, key=lambda eb: eb[0] / eb[1])
            # x, both gains, the four weights, cos/sin and the pos cache rows
            # in; x_out, k_cur / v_cur and the new cache row out
            nbytes = (3 * d * 4 + wbytes + hd * 4 + pos * row_bytes
                      + d * 4 + 2 * nkv * 4 + row_bytes)
            qkv_ops = 2 * d * nqkv
            attn_ops = 2 * hq * pos * hd
            flops = ((0 if a_i8 else qkv_ops) + 2 * nq * d + (1 if kv8 else 2) * attn_ops
                     + 4 * hq * hd + 6 * d * f)
            i8ops = (qkv_ops if a_i8 else 0) + (attn_ops if kv8 else 0)
            record(kname, f"{model}pos={pos} layer={ATTN_LAYER} d_ff={f} (x_out, k_cur, v_cur; "
                   f"bit-equal to K7 + K6d)", worst[0], worst[1], t, tp, nbytes, flops, None,
                   NO_LIBRARY["attn_ffn"], i8ops=i8ops, chain_ms=tc[0], chain_call_ms=tc[1],
                   **stream_plan(plan))

    def check_ffn_nonorm(d, f, model):
        """K6a's no-norm form (fused_ffn_cuda at Q8_0, the training FFN of
        <= 32 rows at Q8_0) at FFN_ROWS against fused_ffn_ref within
        REL_BOUND * max|y|, two launches bit-equal."""
        pairs, wbytes = ffn_weights("q8_0", d, f)
        for m in FFN_ROWS:
            h = torch.randn((1, m, d), device=dev, generator=g)
            got, again = fused_ffn_cuda(h, *pairs[0]), fused_ffn_cuda(h, *pairs[0])
            want = fused_ffn_ref(h, *pairs[0])
            torch.cuda.synchronize()
            err, bound = rel_err(got, want)
            case = f"{model}M={m} D={d} F={f}"
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"fused_ffn_q8 {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"fused_ffn_q8 {case}: two launches differ")
            t = time_ms(torch, [lambda p_=pr: fused_ffn_cuda(h, *p_) for pr in pairs],
                        50 if m == 1 else 10)
            tp = time_ms(torch, [lambda p_=pr: fused_ffn_ref(h, *p_) for pr in pairs], 10)
            record("fused_ffn_q8", case, err, bound, t, tp, 2 * m * d * 4 + wbytes,
                   6 * m * d * f, None, NO_LIBRARY["planar"],
                   **stream_plan(launch_args(dev, ffn_plan, m, d, f, "q8_0", False)[0]))

    def check_ffn_vjp(kind, d, f, model):
        """The fused FFN's dx (ops/ffn.FusedFFN: K6b / K6a no-norm forward,
        K1's recompute of gate|up, K11 twice) at FFN_ROWS on the card
        against the same Function under force_ref(), within max(REL_BOUND *
        max|dx|, SENS_MARGIN x the plain version's own move when h moves by
        SENS_EPS relative): the recompute's int8 activations flip where two
        implementations sum a row in another order. Recorded in the summary
        (ffn_vjp): the device time of forward and backward, the plain one's,
        and its bound (w_gate_up read three times, w_down twice)."""
        from zgml_tpu_torch.ops import dispatch
        pairs, wbytes = ffn_weights(kind, d, f)

        def dx_of(h, gr, pr):
            leaf = h.detach().clone().requires_grad_()
            return torch.autograd.grad(dispatch.fused_ffn(leaf, *pr), leaf, gr)[0]
        for m in FFN_ROWS:
            h = torch.randn((1, m, d), device=dev, generator=g)
            gr = torch.randn((1, m, d), device=dev, generator=g)
            got = dx_of(h, gr, pairs[0])
            with dispatch.force_ref():
                want = dx_of(h, gr, pairs[0])
                gen = torch.Generator(device=dev).manual_seed(SEED)
                moved = max(float((dx_of(h * (1 + SENS_EPS * torch.randn(
                    h.shape, device=dev, generator=gen)), gr, pairs[0]) - want).abs().max())
                    for _ in range(SENS_DRAWS))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            bound = max(REL_BOUND * float(want.abs().max()), SENS_MARGIN * moved)
            case = f"{model}{kind} M={m} D={d} F={f}"
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"ffn_vjp {case}: dx max_abs_err {err:.3g} > bound {bound:.3g}")
            t = time_ms(torch, [lambda p_=pr: dx_of(h, gr, p_) for pr in pairs], 10)
            with dispatch.force_ref():
                tp = time_ms(torch, [lambda p_=pr: dx_of(h, gr, p_) for pr in pairs], 5)
            gu_bytes = nbytes_of(pairs[0][0].qs, pairs[0][0].d)
            b_ms, b_by = bound_of(3 * gu_bytes + 2 * (wbytes - gu_bytes) + 3 * m * d * 4,
                                  12 * m * d * f, i8ops=4 * m * d * f)
            log(f"  ffn_vjp {case}: dx max_abs_err {err:.3g} (bound {bound:.3g}, the plain "
                f"version moves {moved:.3g}); backward device us {t[0] * 1e3:.1f} (forward "
                f"included), plain {tp[0] * 1e3:.1f}; bound {b_ms * 1e3:.1f} us by {b_by}")
            summary_ffn_vjp.append(dict(case=case, err=err, bound=bound, plain_move=moved,
                                        ms=t[0], plain_ms=tp[0], bound_ms=b_ms, bound_by=b_by))

    summary_ffn_vjp = results.setdefault("_ffn_vjp", [])
    log("  -- TinyLlama-1.1B shapes")
    for kind in KINDS:
        for name, n, k in GEMM_SHAPES:
            check_projection(kind, name, n, k, "")
        check_ffn(kind, FFN_D, FFN_F, "", a_i8=False)
        check_attn_block(kind, (L, HQ, HKV, D), "", a_i8=False)
        check_attn_block(kind, (L, HQ, HKV, D), "", a_i8=False, kv8=True)
    check_planar(FFN_D, FFN_F, "")
    log("  -- K7 with phase E (ZGML_TPU_LAYER_FFN), K6a's no-norm form, the fused FFN's dx")
    check_attn_block_ffn((L, HQ, HKV, D), FFN_F, "", a_i8=False, kv8=False)
    check_attn_block_ffn((L, HQ, HKV, D), FFN_F, "", a_i8=False, kv8=True)
    check_attn_block_ffn((L_7B, HQ_7B, HKV_7B, D_7B), FFN_F_7B, "7B ", a_i8=True, kv8=False)
    check_attn_block_ffn((L_7B, HQ_7B, HKV_7B, D_7B), FFN_F_7B, "7B ", a_i8=True, kv8=True)
    log("  -- the f32 KV cache: K7 over it (f32 A at TinyLlama-1.1B, both kinds; the int8 A "
        "phase at Llama-2-7B; with and without phase E), K3 over f32 K / V in both forms")
    for kind in KINDS:
        check_attn_block(kind, (L, HQ, HKV, D), "", a_i8=False, kv8="f32")
    check_attn_block("q4_0", (L_7B, HQ_7B, HKV_7B, D_7B), "7B ", a_i8=True, kv8="f32")
    check_attn_block_ffn((L, HQ, HKV, D), FFN_F, "", a_i8=False, kv8="f32")
    check_attn_block_ffn((L_7B, HQ_7B, HKV_7B, D_7B), FFN_F_7B, "7B ", a_i8=True, kv8="f32")
    for shape, model in (((L, HQ, HKV, D), ""), ((L_7B, HQ_7B, HKV_7B, D_7B), "7B ")):
        check_attention_f32kv(torch, dev, g, record, shape, model)
    check_ffn_nonorm(FFN_D, FFN_F, "")
    for kind in KINDS:
        check_ffn_vjp(kind, FFN_D, FFN_F, "")
    check_attention(torch, dev, g, record, flash_attention_cuda, flash_attention_ref,
                    decode_attention_cuda, decode_attention_ref, (L, HQ, HKV, D), "")
    check_attention_q8(torch, dev, g, record, (L, HQ, HKV, D), "", KV8_DECODE_LENS, ptxas_q8)
    log("  -- the bf16 forms (ZGML_TPU_PREFILL_BF16) at TinyLlama-1.1B and Llama-2-7B shapes")
    for kind in KINDS:
        for shapes, model in ((GEMM_SHAPES, ""), (GEMM_SHAPES_7B, "7B ")):
            for name, n, k in shapes:
                check_projection_bf16(torch, dev, g, record, weights, kind, name, n, k, model)
    for shape, model in (((L, HQ, HKV, D), ""), ((L_7B, HQ_7B, HKV_7B, D_7B), "7B ")):
        for kv8 in (False, True):
            check_attention_bf16(torch, dev, g, record, shape, model, kv8)
    check_training_attention_bf16(torch, dev, g, record)
    log("  -- GPT-2 XL (25 heads of 64, n_rep 1, n_ctx 1024): K3's bf16 form and K4; Whisper "
        "large-v3's decoder: K4's f32 form")
    hd_gpt = GPT2_XL["d_model"] // GPT2_XL["n_heads"]
    check_attention_bf16(torch, dev, g, record, (2, GPT2_XL["n_heads"], GPT2_XL["n_heads"], hd_gpt),
                         "GPT-2 XL ", False, GPT2_XL["max_seq_len"], GPT_FLASH_CASES)
    for kv_len in GPT_DECODE_LENS:
        check_decode_case(torch, dev, g, record, "decode_attention", GPT2_XL["n_heads"],
                          GPT2_XL["n_heads"], hd_gpt, GPT2_XL["max_seq_len"], kv_len, "GPT-2 XL ",
                          torch.bfloat16)
    log("  -- GPT-2 XL's f32 cache (gpt2_xl_f32): K3 over f32 K / V in both forms, K4's f32 "
        "form")
    gpt_heads = (2, GPT2_XL["n_heads"], GPT2_XL["n_heads"], hd_gpt)
    check_attention_f32kv(torch, dev, g, record, gpt_heads, "GPT-2 XL ", GPT2_XL["max_seq_len"],
                          GPT_FLASH_CASES)
    for kv_len in GPT_DECODE_LENS:
        check_decode_case(torch, dev, g, record, "decode_attention_f32", GPT2_XL["n_heads"],
                          GPT2_XL["n_heads"], hd_gpt, GPT2_XL["max_seq_len"], kv_len, "GPT-2 XL ",
                          torch.float32)
    for label, hq, hkv, hd, s_, kv_len in F32_DECODE_CASES:
        check_decode_case(torch, dev, g, record, "decode_attention_f32", hq, hkv, hd, s_, kv_len,
                          f"Whisper large-v3 {label} " if hd == 64 else f"{label} ",
                          torch.float32)
    log("  -- Llama-2-7B shapes")
    for name, n, k in GEMM_SHAPES_7B:
        check_projection("q4_0", name, n, k, "7B ")
    check_ffn("q4_0", FFN_D_7B, FFN_F_7B, "7B ", a_i8=True)
    check_planar(FFN_D_7B, FFN_F_7B, "7B ")
    for kind in KINDS:
        check_attn_block(kind, (L_7B, HQ_7B, HKV_7B, D_7B), "7B ", a_i8=True)
        check_attn_block(kind, (L_7B, HQ_7B, HKV_7B, D_7B), "7B ", a_i8=True, kv8=True)
    check_attention(torch, dev, g, record, flash_attention_cuda, flash_attention_ref,
                    None, None, (L_7B, HQ_7B, HKV_7B, D_7B), "7B hd=128 n_rep=1 ",
                    FLASH_CASES + FLASH_CASES_7B_LONG)
    check_attention_q8(torch, dev, g, record, (L_7B, HQ_7B, HKV_7B, D_7B), "7B ",
                       KV8_DECODE_LENS_7B, ptxas_q8)
    log("  -- the parallel paths' shapes: a tp-2 rank of tp2_7b and of serve_mesh_tiny "
        "(GEMM_SHAPES*_TP2), cp2_tiny's 768-row cp body and its ring hops")
    for name, n, k in GEMM_SHAPES_7B_TP2:           # tp2_7b's PAR_CHUNK-row prefill chunks
        check_projection_bf16(torch, dev, g, record, weights, "q4_0", name, n, k, "7B tp2 ",
                              rows=(PAR_CHUNK,))
    # its decode: K7's int8 A phase on 16 local heads, K6c at local d_ff, K1
    # on the head's rows (gathered after it; no K5 under tp)
    check_attn_block("q4_0", (L_7B, HQ_7B // 2, HKV_7B // 2, D_7B), "7B tp2 ", a_i8=True,
                     d=FFN_D_7B)
    check_ffn("q4_0", FFN_D_7B, FFN_F_7B // 2, "7B tp2 ", a_i8=True)
    check_projection("q4_0", "lm_head", 16000, FFN_D_7B, "7B tp2 ", k2_rows=(), i8_rows=(1,),
                     greedy=False)
    # serve_mesh_tiny at tp 2: SERVE_CHUNK-row chunks, then SERVE_BATCH-row
    # decode steps (K1 on wqkv, wo and the head, K6b at local d_ff, K4 over 2
    # local KV heads; K3 keeps n_rep 8 and only loses heads of its grid)
    for name, n, k in GEMM_SHAPES_TP2:
        check_projection_bf16(torch, dev, g, record, weights, "q4_0", name, n, k, "tp2 ",
                              rows=(SERVE_CHUNK,))
        if name in ("wqkv", "wo", "lm_head"):
            check_projection("q4_0", name, n, k, "tp2 ", k2_rows=(), i8_rows=(SERVE_BATCH,),
                             greedy=False)
    check_planar(FFN_D, FFN_F // 2, "tp2 ", rows=(SERVE_BATCH,))
    from zgml_tpu_torch.ops.decode_plan import sm_count
    kc_tp, vc_tp = (torch.randn((L, HKV // 2, S, D), device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
    check_decode_batch(torch, dev, g, record, decode_attention_cuda, decode_attention_ref, kc_tp,
                       vc_tp, (L, HQ // 2, HKV // 2, D), "tp2 ", SERVE_DECODE_LENS,
                       sm_count(dev.index or 0))
    del kc_tp, vc_tp
    for name, n, k in GEMM_SHAPES[:4]:              # cp2_tiny: LONG_PROMPT / 2 rows a rank
        check_projection_bf16(torch, dev, g, record, weights, "q4_0", name, n, k, "cp2 ",
                              rows=(LONG_PROMPT // PAR_RANKS,))
    check_ring_hops(torch, dev, g, record)
    log("  -- training: K10 (flash forward with LSE, dQ, dK/dV) and K11 (dx)")
    check_training_attention(torch, dev, g, record)
    for kind in KINDS:
        for name, n, k in GEMM_SHAPES:
            check_qmatmul_bwd(torch, dev, g, record, weights, kind, name, n, k)
    log("  -- the graph tier and the forced norm: K12 (rmsnorm) and K13 (fused chain)")
    check_rmsnorm(torch, dev, g, record)
    check_chains(torch, dev, g, record)
    for dtype in (torch.bfloat16, torch.float16):
        check_chains_16(torch, dev, g, record, dtype)
    log("  -- the whole-stack decode megacalls: K14 (stack_decode) and K15 (tape_decode)")
    check_megacalls(torch, dev, g, record, weights)
    log("  -- the 70B shapes of ROADMAP B.6: K1q8's K-split form, K14's global table")
    check_wide(torch, dev, g, record, weights)
    return results


def check_greedy(torch, dev, g, kind, copies, record, greedy_cuda, greedy_ref,
                 qmatmul_i8_cuda, qmatmul_i8_ref, model):
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
    record(kname, f"{model}lm_head N={w.n} K={w.k}, {GREEDY_TRIALS} rows: ids != argmax(K1) "
           f"{off_k1}/{GREEDY_TRIALS}, != plain id {off_plain}/{compared} (rows whose "
           f"plain top-2 gap exceeds the bound); error = max(plain) - plain[id]",
           err, bound, t, tp, w.k * 4 + nbytes_of(w.qs, w.d) + 8, 0, None,
           NO_LIBRARY["greedy"], i8ops=2 * w.n * w.k)


def check_attention(torch, dev, g, record, flash_attention_cuda, flash_attention_ref,
                    decode_attention_cuda, decode_attention_ref, shape, model,
                    flash_cases=FLASH_CASES):
    """K3 at flash_cases (q_offset, kv_len) (and K4, where its wrappers are
    given) over a random stacked cache; the library call is
    scaled_dot_product_attention with enable_gqa over the same cache rows,
    cast to f32 outside the timed window."""
    from zgml_tpu_torch.ops.attention import flash_plan
    n_layers, hq, hkv, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc = torch.randn((n_layers, hkv, S, hd), device=dev, generator=g).to(torch.bfloat16)
    vc = torch.randn((n_layers, hkv, S, hd), device=dev, generator=g).to(torch.bfloat16)
    for q_off, kv_len in flash_cases:
        q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
        row = (q_off // 128) % n_layers
        got = flash_attention_cuda(q, kc, vc, kv_len, q_off, row)
        want = flash_attention_ref(q, kc, vc, kv_len, q_off, row)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= 1e-5,
                f"flash_attention {model}q_offset={q_off} kv_len={kv_len}: max_abs_err "
                f"{err:.3g}")
        t = time_ms(torch, [lambda: flash_attention_cuda(q, kc, vc, kv_len, q_off, row)], 50)
        tp = time_ms(torch, [lambda: flash_attention_ref(q, kc, vc, kv_len, q_off, row)], 20)
        kf = kc[row:row + 1, :, :kv_len].float()
        vf = vc[row:row + 1, :, :kv_len].float()
        qi = torch.arange(128, device=dev)[:, None] + q_off
        mask = torch.arange(kv_len, device=dev)[None, :] <= qi
        lib_err = float((sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True) - want).abs().max())
        lib = time_ms(torch, [lambda: sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True)], 50)
        live = int(mask.sum())                         # (query, key) pairs attended
        plan = flash_plan(q, kc, kv_len, q_off, False)
        record("flash_attention", f"{model}Tq=128 q_offset={q_off} kv_len={kv_len} "
               f"n_split={plan.n_split}", err, 1e-5, t, tp,
               2 * q.numel() * 4 + 2 * kv_len * hkv * hd * 2, 0, lib,
               f"scaled_dot_product_attention(enable_gqa=True, boolean causal mask), f32 "
               f"(max abs err {lib_err:.2g})", tf32ops=TF32_PASSES * 4 * hq * live * hd,
               n_split=plan.n_split)
    if decode_attention_cuda is None:
        return
    from zgml_tpu_torch.ops.decode_plan import decode_splits, sm_count
    sms = sm_count(dev.index or 0)
    for kv_len in DECODE_LENS:
        q = torch.randn((1, hq, 1, hd), device=dev, generator=g)
        lens = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        row = kv_len % n_layers
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
        require(bool(torch.equal(got, decode_attention_cuda(q, kc, vc, lens, row))),
                f"decode_attention kv_len={kv_len}: two launches differ")
        record("decode_attention", f"{model}kv_len={kv_len}", err, 1e-5, t, tp,
               2 * q.numel() * 4 + 2 * kv_len * hkv * hd * 2, 4 * hq * kv_len * hd, lib,
               f"scaled_dot_product_attention(enable_gqa=True), one query, f32 "
               f"(max abs err {lib_err:.2g})", n_split=decode_splits(1, hkv, S, hd, sms))
    # batch 4 and the serving paths' batch 8, per-row kv_len (rows kv_row ..
    # kv_row + B - 1 of the stacked cache)
    for batch_lens in (DECODE_BATCH_LENS, SERVE_DECODE_LENS):
        check_decode_batch(torch, dev, g, record, decode_attention_cuda, decode_attention_ref,
                           kc, vc, shape, model, batch_lens, sms)


def check_decode_batch(torch, dev, g, record, decode_attention_cuda, decode_attention_ref,
                       kc, vc, shape, model, batch_lens, sms):
    """K4 at one batch of per-row kv_len (one 0: a row of no key gives 0)."""
    from zgml_tpu_torch.ops.decode_plan import decode_splits
    _, hq, hkv, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b = len(batch_lens)
    q = torch.randn((b, hq, 1, hd), device=dev, generator=g)
    lens = torch.tensor(batch_lens, dtype=torch.int32, device=dev)
    row = 2
    got, again = (decode_attention_cuda(q, kc, vc, lens, row) for _ in range(2))
    want = decode_attention_ref(q, kc, vc, lens, row)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    case = f"{model}B={b} kv_len={batch_lens}"
    require(bool(torch.isfinite(got).all()) and err <= 1e-5 and bool(torch.equal(got, again))
            and not bool(got[batch_lens.index(0)].any()),
            f"decode_attention {case}: max_abs_err {err:.3g}, or two launches differ, or the "
            f"kv_len 0 row is not 0")
    t = time_ms(torch, [lambda: decode_attention_cuda(q, kc, vc, lens, row)], 100)
    tp = time_ms(torch, [lambda: decode_attention_ref(q, kc, vc, lens, row)], 20)
    keys = sum(batch_lens)
    lib_err, lib = 0.0, None
    outs = []
    for i, n in enumerate(batch_lens):     # SDPA row by row: one call per kv_len
        if n:
            outs.append((q[i:i + 1], kc[row + i:row + i + 1, :, :n].float(),
                         vc[row + i:row + i + 1, :, :n].float()))
            lib_err = max(lib_err, float((sdpa(*outs[-1], enable_gqa=True)
                                          - want[i:i + 1]).abs().max()))

    def lib_rows():
        for a in outs:
            sdpa(*a, enable_gqa=True)
    lib = time_ms(torch, [lib_rows], 50)
    record("decode_attention", case, err, 1e-5, t, tp,
           2 * q.numel() * 4 + 2 * keys * hkv * hd * 2, 4 * hq * keys * hd, lib,
           f"scaled_dot_product_attention(enable_gqa=True), one call per live row (kv_len "
           f"differs by row), f32 (max abs err {lib_err:.2g})",
           n_split=decode_splits(b, hkv, S, hd, sms))


def check_decode_case(torch, dev, g, record, kname, hq, hkv, hd, s, kv_len, label, dtype):
    """K4 (`dtype` bf16) or its f32 form (float32) at one batch-1 case over a
    random cache of 3 rows of `s` positions (row 1 read through kv_row):
    within 1e-5 of the plain version, two launches bit-equal; the bound
    counts the live K / V rows at the cache's element size; library:
    scaled_dot_product_attention(enable_gqa=True) in f32 over the same rows."""
    from zgml_tpu_torch.ops.attention import (decode_attention_cuda, decode_attention_ref,
                                              decode_per_sm)
    from zgml_tpu_torch.ops.decode_plan import decode_splits, sm_count
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc = torch.randn((3, hkv, s, hd), device=dev, generator=g).to(dtype)
    vc = torch.randn((3, hkv, s, hd), device=dev, generator=g).to(dtype)
    q = torch.randn((1, hq, 1, hd), device=dev, generator=g)
    lens = torch.full((1,), kv_len, dtype=torch.int32, device=dev)

    def launch():
        return decode_attention_cuda(q, kc, vc, lens, 1)
    got, again = launch(), launch()
    want = decode_attention_ref(q, kc, vc, lens, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    case = f"{label}Hq={hq} Hkv={hkv} hd={hd} S={s} kv_len={kv_len}"
    require(bool(torch.isfinite(got).all()) and err <= 1e-5 and bool(torch.equal(got, again)),
            f"{kname} {case}: max_abs_err {err:.3g}, or two launches differ")
    t = time_ms(torch, [launch], 100)
    tp = time_ms(torch, [lambda: decode_attention_ref(q, kc, vc, lens, 1)], 20)
    kf, vf = (c[1:2, :, :kv_len].float() for c in (kc, vc))
    lib_err = float((sdpa(q, kf, vf, enable_gqa=True) - want).abs().max())
    lib = time_ms(torch, [lambda: sdpa(q, kf, vf, enable_gqa=True)], 100)
    n_split = decode_splits(1, hkv, s, hd, sm_count(dev.index or 0),
                            per_sm=decode_per_sm(hd, dtype == torch.float32))
    record(kname, case, err, 1e-5, t, tp,
           2 * q.numel() * 4 + 2 * kv_len * hkv * hd * kc.element_size(), 4 * hq * kv_len * hd,
           lib, f"scaled_dot_product_attention(enable_gqa=True), one query, f32 (max abs err "
           f"{lib_err:.2g})", n_split=n_split)


def k8_smem_bytes(hd: int, n_rep: int) -> int:
    """K8's dynamic shared memory (csrc/decode_attn.cu dq_smem_bytes): q
    levels and scales, p, the block maxima, the warps' merge area, each
    warp's steps (two, one at head_dim 128) of two groups (K rows padded by
    16 bytes, V, scales), the merge flag and its split maxima and sums."""
    def r16(n):
        return -(-n // 16) * 16
    group, stages = 32 * (2 * hd + 16) + 2 * 32 * 4, 1 if hd >= 128 else 2
    return (r16(n_rep * hd) + r16(n_rep * 4) + 4 * 4 * 8 * (2 * 32 + 4 + hd)
            + 4 * stages * 2 * group + 16 + 4 * n_rep * 2 * 16)


def check_attention_q8(torch, dev, g, record, shape, model, decode_lens, ptxas):
    """K9 and K8 over a random stacked int8 cache (levels and per-position
    scales, read through kv_row): K9 on a 128-row chunk at KV8_FLASH_CASES,
    K8 in both its modes on one row per entry of decode_lens (each a batch
    of per-row kv_len): against the plain version of its launch plan (the
    I8PV mode: each split's running max from its first JAX block) within
    max(1e-5 * max|o|, FLIP_MARGIN x the plain version's own move under a
    FLIP_EPS move of its score scale) in the I8PV mode (p * v_scale / psc
    at a half rounds to the other level), 1e-5 * max|o| in the f32-p one,
    and in the I8PV mode each shortcut (the f32-p function, p quantized per
    32-key group) farther from that plain version than the bound;
    two launches bit-equal; a kv_len 0 row 0; its plan's n_split, shared
    memory and ptxas' registers and spills recorded. The library call is
    scaled_dot_product_attention with enable_gqa in f32 on the cache rows
    dequantized outside the timed window (for K8's f32-p mode on q quantized
    and dequantized as the kernel does; none for the I8PV mode)."""
    from zgml_tpu_torch.ops.attention import (decode_attention_q8_cuda, decode_attention_q8_ref,
                                              decode_q8_splits, flash_attention_q8_cuda,
                                              flash_attention_q8_ref, flash_plan, q8_counter)
    from zgml_tpu_torch.quant.kv_cache import dequantize, quantize_columns
    n_layers, hq, hkv, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bmax = max(len(lens) for lens in decode_lens)
    rows = n_layers * bmax
    k = torch.randint(-127, 128, (rows, hkv, S, hd), dtype=torch.int8, device=dev, generator=g)
    v = torch.randint(-127, 128, (rows, hkv, S, hd), dtype=torch.int8, device=dev, generator=g)
    ks = torch.rand((rows, hkv, S), device=dev, generator=g) * 0.01 + 0.01
    vs = torch.rand((rows, hkv, S), device=dev, generator=g) * 0.01 + 0.01
    pos_bytes = 2 * hkv * (hd + 4)              # K and V levels and scales of one position
    for q_off, kv_len in KV8_FLASH_CASES:
        q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
        row = (q_off // 128) % rows
        args = (q, k, ks, v, vs, kv_len, q_off, row)
        got, want = flash_attention_q8_cuda(*args), flash_attention_q8_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= 1e-5,
                f"flash_attention_q8 {model}q_offset={q_off} kv_len={kv_len}: max_abs_err "
                f"{err:.3g}")
        t = time_ms(torch, [lambda: flash_attention_q8_cuda(*args)], 50)
        tp = time_ms(torch, [lambda: flash_attention_q8_ref(*args)], 20)
        kf = dequantize(k[row:row + 1, :, :kv_len], ks[row:row + 1, :, :kv_len])
        vf = dequantize(v[row:row + 1, :, :kv_len], vs[row:row + 1, :, :kv_len])
        qi = torch.arange(128, device=dev)[:, None] + q_off
        mask = torch.arange(kv_len, device=dev)[None, :] <= qi
        lib_err = float((sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True) - want).abs().max())
        lib = time_ms(torch, [lambda: sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True)], 50)
        live = int(mask.sum())
        plan = flash_plan(q, k, kv_len, q_off, True)
        record("flash_attention_q8", f"{model}hd={hd} Tq=128 q_offset={q_off} kv_len={kv_len} "
               f"kv_row={row} n_split={plan.n_split}", err, 1e-5, t, tp,
               2 * q.numel() * 4 + kv_len * pos_bytes, 0, lib,
               f"scaled_dot_product_attention(enable_gqa=True, boolean causal mask), f32, after "
               f"an untimed dequant (max abs err {lib_err:.2g})",
               tf32ops=TF32_PASSES * 4 * hq * live * hd, n_split=plan.n_split)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for lens_ in decode_lens:
        b = len(lens_)
        q = torch.randn((b, hq, 1, hd), device=dev, generator=g)
        lens = torch.tensor(lens_, dtype=torch.int32, device=dev)
        row = (n_layers - 1) * b                      # the last layer's rows
        args = (q, k, ks, v, vs, lens, row)
        n = max(lens_)
        qq, qs = quantize_columns(q)
        qf = dequantize(qq, qs)
        kf = dequantize(k[row:row + b, :, :n], ks[row:row + b, :, :n])
        vf = dequantize(v[row:row + b, :, :n], vs[row:row + b, :, :n])
        mask = (torch.arange(n, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        live = sum(lens_)
        for i8pv in (False, True):
            name = q8_counter(i8pv)
            n_split = decode_q8_splits(b, hkv, S, hd, sms, i8pv)

            def launch(i8pv=i8pv):
                return decode_attention_q8_cuda(*args, i8pv)

            def plain(scale=None, split=n_split, i8pv=i8pv):
                return decode_attention_q8_ref(*args, i8pv, split=split, scale=scale)
            got, again, want = launch(), launch(), plain()
            move = max(float((plain((1 + e) / hd ** 0.5) - want).abs().max())
                       for e in FLIP_EPS) if i8pv else 0.0
            torch.cuda.synchronize()
            case = f"{model}hd={hd} B={b} kv_len={lens_} n_split={n_split}"
            mx = float(want.abs().max())
            err, bound = float((got - want).abs().max()), max(1e-5 * mx, FLIP_MARGIN * move)
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{name} {case}: max_abs_err {err:.3g} > {bound:.3g} (flip move {move:.3g})")
            require(bool(torch.equal(got, again)), f"{name} {case}: two launches differ")
            require(all(not got[i].any() for i, n_ in enumerate(lens_) if n_ == 0),
                    f"{name} {case}: a row with kv_len 0 is not 0")
            t = time_ms(torch, [launch], 100)
            tp = time_ms(torch, [plain], 20 if not i8pv else 5)
            if i8pv:
                lib, note = None, "none: no call quantizes p per block"
                # the bound must tell the function from its shortcuts: f32 p
                # against the levels, and p quantized per 32-key group
                shortcuts = {"f32_p": plain(i8pv=False),
                             "per_32_keys": decode_attention_q8_ref(*args, True, split=n_split,
                                                                    block=32)}
                gaps = {k_: float((o_ - want).abs().max()) for k_, o_ in shortcuts.items()}
                require(all(gap > bound for gap in gaps.values()),
                        f"{name} {case}: a shortcut lies within the bound {bound:.3g}: {gaps}")
                log(f"  {name} {case}: bound {bound:.3g} (flip move {move:.3g}); the shortcuts "
                    f"lie " + ", ".join(f"{k_} {v_:.3g} ({v_ / bound:.1f}x)"
                                        for k_, v_ in gaps.items()) + " from the plain version")
                extra = dict(flip_move=move, shortcut_gaps=gaps,
                             vs_unsplit=float((got - plain(split=None)).abs().max()) / mx)
                ops = dict(i8ops=4 * hq * live * hd)             # q.k and P.V both int8
                flops = 0
            else:
                lib_err = float((sdpa(qf, kf, vf, attn_mask=mask, enable_gqa=True) - want)
                                .abs().max())
                lib = time_ms(torch, [lambda: sdpa(qf, kf, vf, attn_mask=mask, enable_gqa=True)],
                              100)
                note = (f"scaled_dot_product_attention(enable_gqa=True, per-row mask), f32, "
                        f"after an untimed dequant of q and the cache (max abs err "
                        f"{lib_err:.2g})")
                extra, ops, flops = {}, dict(i8ops=2 * hq * live * hd), 2 * hq * live * hd
            entry = next((e for e in ptxas
                          if f"decode_q8_kernelILi{hd}ELb{int(i8pv)}E" in e["entry"]), {})
            record(name, case, err, bound, t, tp,
                   2 * q.numel() * 4 + b * 4 + live * pos_bytes, flops, lib, note,
                   n_split=n_split, smem_bytes=k8_smem_bytes(hd, hq // hkv),
                   registers=entry.get("registers"), spill_stores=entry.get("spill_stores"),
                   **ops, **extra)


def bf16_ulp(torch, x):
    """The spacing of bf16 numbers at |x| (8 significant bits), f64, exact."""
    ax = x.double().abs()
    _, e = torch.frexp(torch.where(ax > 0, ax, torch.full_like(ax, 2.0 ** -126)))
    return torch.ldexp(torch.ones_like(ax), e - 8)


def check_bf16_ulp(torch, got, want, what, extra=0.0):
    """(max abs err, the largest tolerance): got within one bf16 ulp of want
    per element, or 1e-6 * max|want| where the sum cancels to below f32 noise
    (tests/test_torch_flash_vjp.py), or `extra` where given."""
    gd, wd = got.double(), want.double()
    tol = torch.maximum(torch.maximum(bf16_ulp(torch, wd), bf16_ulp(torch, gd)),
                        torch.full_like(wd, max(extra, 1e-6 * float(wd.abs().max()))))
    n_bad = int(((gd - wd).abs() > tol).sum())
    require(n_bad == 0 and bool(torch.isfinite(gd).all()),
            f"{what}: {n_bad} elements more than one bf16 ulp from plain")
    return float((gd - wd).abs().max()), float(tol.max())


def efficient_attention(torch, q, k, v, do, kv_len, q_off, dtype=None):
    """The library yardstick of K10: aten's memory-efficient attention with
    compute_log_sumexp (f32, or `dtype`: the bf16 forms' yardstick in bf16)
    and its backward, on k / v cast and expanded to the query heads outside
    the timed calls; the causal offset as an additive bias where the mask is
    not top-left. Returns (forward call, backward call, note) or (None,
    None, why not)."""
    dtype = dtype or torch.float32
    q, do = q.to(dtype), do.to(dtype)
    b, hq, tq, d = q.shape
    rep = hq // k.shape[1]
    kf = k[:, :, :kv_len].to(dtype).repeat_interleave(rep, 1).contiguous()
    vf = v[:, :, :kv_len].to(dtype).repeat_interleave(rep, 1).contiguous()
    top_left = q_off == 0 and kv_len == tq
    bias = None
    if not top_left:
        qi = torch.arange(tq, device=q.device)[:, None] + q_off
        ki = torch.arange(kv_len, device=q.device)[None, :]
        # rows padded to 16 keys: the bf16 kernel wants the bias's row stride
        # a multiple of 8 (kv_len 300 is not); the view keeps kv_len columns
        width = -(-kv_len // 16) * 16
        bias = torch.zeros((tq, width), device=q.device, dtype=dtype)[:, :kv_len]
        bias.masked_fill_(ki > qi, float("-inf"))
        bias = bias.expand(b, hq, tq, kv_len)
    eff = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    scale = 1.0 / d ** 0.5
    try:
        out = eff(q, kf, vf, bias, True, 0.0, top_left, scale=scale)
        grads = eff_bwd(do, q, kf, vf, bias, out[0], out[1], out[2], out[3], 0.0,
                        [True, True, True, False], top_left, scale=scale)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, None, f"none: aten's efficient attention refused ({type(e).__name__}: " \
                           f"{str(e)[:120]})"
    del grads

    def fwd():
        return eff(q, kf, vf, bias, True, 0.0, top_left, scale=scale)

    def bwd():
        return eff_bwd(do, q, kf, vf, bias, out[0], out[1], out[2], out[3], 0.0,
                       [True, True, True, False], top_left, scale=scale)
    return fwd, bwd, ("aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True) "
                      + ("f32" if dtype == torch.float32 else "bf16")
                      + ("" if top_left else " with an additive causal bias"))


def dq_float64(torch, q, k, v, do, o, lse, kv_len, q_off):
    """dQ in float64 from the same inputs (o and lse the kernel's)."""
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv, tq, d)
    dog = do.double().reshape(qg.shape)
    kd, vd = k.double(), v.double()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) / d ** 0.5
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_off
    p = torch.where((ki < kv_len) & (ki <= qi),
                    torch.exp(sc - lse.double().reshape(*qg.shape[:-1], 1)),
                    torch.zeros_like(sc))
    del sc
    delta = (dog * o.double().reshape(qg.shape)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bgrqd,bgkd->bgrqk", dog, vd) - delta) / d ** 0.5
    return torch.einsum("bgrqk,bgkd->bgrqd", ds, kd).reshape(b, hq, tq, d)


def check_training_attention(torch, dev, g, record):
    """K10f, K10dq and K10dkv against their plain versions (ops/flash_vjp.py)
    on the same inputs: K10f's O bit-equal to K3's and its LSE within
    REL_BOUND * max, dQ within REL_BOUND * max and its rms error against
    float64 at most K10_RMS_RATIO x the plain version's (cuBLAS f32), dK / dV
    within one bf16 ulp per element (the backward from the kernel's own o and
    lse), K10dq and K10dkv bit-equal over two launches (fixed split plans)."""
    from zgml_tpu_torch.ops.attention import flash_attention_cuda, flash_plan
    from zgml_tpu_torch.ops.flash_vjp import (flash_delta_cuda, flash_dkv_cuda, flash_dkv_plan,
                                              flash_dkv_ref, flash_dq_cuda, flash_dq_plan,
                                              flash_dq_ref, flash_fwd_lse_cuda,
                                              flash_fwd_lse_ref)
    for label, b, hq, hkv, tq, s, hd, kv_len, q_off in TRAIN_FLASH_CASES:
        q = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        k = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        do = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        args = (q, k, v, kv_len, q_off)
        o, lse = flash_fwd_lse_cuda(*args)
        o3 = flash_attention_cuda(*args)
        o_r, lse_r = flash_fwd_lse_ref(*args)
        bargs = (q, k, v, do, o, lse, kv_len, q_off)
        # the second launch of each from the pre-pass's delta, as the
        # backward hands it to both
        delta = flash_delta_cuda(do, o)
        dq, (dk, dv) = flash_dq_cuda(*bargs), flash_dkv_cuda(*bargs)
        dq2, (dk2, dv2) = flash_dq_cuda(*bargs, delta=delta), flash_dkv_cuda(*bargs, delta=delta)
        dq_r, (dk_r, dv_r) = flash_dq_ref(*bargs), flash_dkv_ref(*bargs)
        torch.cuda.synchronize()
        case = f"{label} Hq={hq} Hkv={hkv} hd={hd} Tq={tq} S={s} kv_len={kv_len} q_offset={q_off}"
        require(torch.equal(o.view(torch.int32), o3.view(torch.int32)),
                f"flash_fwd {case}: O is not K3's O bit for bit")
        err_o, bound_o = float((o - o_r).abs().max()), REL_BOUND * float(o_r.abs().max())
        err_l, bound_l = float((lse - lse_r).abs().max()), REL_BOUND * float(lse_r.abs().max())
        require(err_o <= bound_o and err_l <= bound_l,
                f"flash_fwd {case}: o err {err_o:.3g} (bound {bound_o:.3g}), lse err "
                f"{err_l:.3g} (bound {bound_l:.3g})")
        err_q, bound_q = float((dq - dq_r).abs().max()), REL_BOUND * float(dq_r.abs().max())
        require(bool(torch.isfinite(dq).all()) and err_q <= bound_q,
                f"flash_dq {case}: max_abs_err {err_q:.3g} > bound {bound_q:.3g}")
        kv_errs = [check_bf16_ulp(torch, a, r, f"flash_dkv {case} {n}")
                   for n, a, r in (("dk", dk, dk_r), ("dv", dv, dv_r))]
        err_kv = max(kv_errs)
        require(torch.equal(dq.view(torch.int32), dq2.view(torch.int32)),
                f"flash_dq {case}: two launches differ")
        require(torch.equal(dk.view(torch.int16), dk2.view(torch.int16))
                and torch.equal(dv.view(torch.int16), dv2.view(torch.int16)),
                f"flash_dkv {case}: two launches differ")
        exact = dq_float64(torch, *bargs)
        rms, rms_plain = (float((x.double() - exact).square().mean().sqrt()) for x in (dq, dq_r))
        del exact, dq2, dk2, dv2
        require(rms <= K10_RMS_RATIO * rms_plain,
                f"flash_dq {case}: rms error vs float64 {rms:.3g} > {K10_RMS_RATIO} x plain's "
                f"{rms_plain:.3g}")
        # (query, key) pairs attended per head, and the bytes each kernel must move
        live = sum(min(kv_len, q_off + i + 1) for i in range(tq))
        heads = b * hq
        qbytes, lbytes = q.numel() * 4, b * hq * tq * 4
        kvbytes = 2 * b * hkv * kv_len * hd * 2
        fwd_lib, bwd_lib, note = efficient_attention(torch, q, k, v, do, kv_len, q_off)
        t = time_ms(torch, [lambda: flash_fwd_lse_cuda(*args)], 20)
        tp = time_ms(torch, [lambda: flash_fwd_lse_ref(*args)], 5)
        lib = time_ms(torch, [fwd_lib], 20) if fwd_lib else None
        plan = flash_plan(q, k, kv_len, q_off, False)
        record("flash_fwd", case + f" n_split={plan.n_split} (O bit-equal to K3's; lse err "
               f"{err_l:.3g})", err_o, bound_o, t, tp, qbytes * 2 + lbytes + kvbytes, 0, lib,
               note, tf32ops=TF32_PASSES * 4 * heads * live * hd, n_split=plan.n_split)
        # K10dq and K10dkv timed from the pre-pass's delta, which one backward
        # computes once for both (its time, delta_ms, stands beside each)
        t_delta = time_ms(torch, [lambda: flash_delta_cuda(do, o)], 20)[0]
        t = time_ms(torch, [lambda: flash_dq_cuda(*bargs, delta=delta)], 20)
        tp = time_ms(torch, [lambda: flash_dq_ref(*bargs)], 5)
        lib = time_ms(torch, [bwd_lib], 20) if bwd_lib else None
        bnote = note if bwd_lib is None else (
            "aten._scaled_dot_product_efficient_attention_backward f32, one call computing dQ, "
            "dK and dV (the same time stands beside K10dq and K10dkv)")
        # the bytes of the function (q, dO, O, lse, K / V in, dQ or dK / dV
        # out) and delta, the pre-pass's row sums, written and read once
        nq, nkv = flash_dq_plan(q, k, kv_len, q_off).n_split, \
            flash_dkv_plan(q, k, kv_len, q_off).n_split
        record("flash_dq", case + f" n_split={nq} (bit-equal over two launches; rms error vs "
               f"float64 {rms / rms_plain:.2f}x plain's)", err_q, bound_q, t, tp,
               qbytes * 4 + 2 * lbytes + kvbytes, 0, lib, bnote,
               tf32ops=K10DQ_TF32 * heads * live * hd, n_split=nq, rms_ratio=rms / rms_plain,
               delta_ms=t_delta)
        t = time_ms(torch, [lambda: flash_dkv_cuda(*bargs, delta=delta)], 20)
        tp = time_ms(torch, [lambda: flash_dkv_ref(*bargs)], 5)
        record("flash_dkv", case + f" n_split={nkv} (dK, dV within one bf16 ulp per element; "
               f"bit-equal over two launches)", err_kv[0], err_kv[1], t, tp,
               qbytes * 3 + 2 * lbytes + kvbytes + 2 * heads * s * hd * 2, 0, lib, bnote,
               tf32ops=K10DKV_TF32 * heads * live * hd, bf16ops=K10DKV_BF16 * heads * live * hd,
               n_split=nkv, delta_ms=t_delta)
        log(f"  flash backward {case}: the delta pre-pass {t_delta * 1e3:.1f} us, once per "
            f"backward for both kernels")


def check_projection_bf16(torch, dev, g, record, weights, kind, name, n, k, model,
                          rows=K2_BF16_ROWS):
    """K2's bf16 form at `rows` (K2_BF16_ROWS) (and, on lm_head, its one row at
    tier_rows K2_HEAD_TIER, the GEMV's bf16 mode) against
    qmatmul_ref(bf16=True): the pre-pass's bf16(x) bit-equal to torch's
    rounding, two launches bit-equal, max-abs error within K2_BF16_RTOL *
    max|y|, and rms error against a float64 evaluation of the same bf16
    operands at most BF16_RMS_RATIO x the plain version's. The bound counts
    one bf16 product per dot (the GEMV: f32 FMAs on the CUDA cores); the
    library call is a bf16 torch.matmul on x and the weight rounded to bf16
    outside the timed window (cuBLAS; bf16 output)."""
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.dispatch import qmatmul as dispatch_qmatmul
    from zgml_tpu_torch.ops.qmatmul import _fwd_card, qmatmul_cuda, qmatmul_plan, qmatmul_ref
    from zgml_tpu_torch.runtime.profile import global_profile
    copies = weights(kind, n, k)
    w = copies[0]
    wbytes = nbytes_of(w.qs, w.d)
    kname = NAME["matmul", kind] + "_bf16"
    wbs = [refs.bf16_round(c.dequant()).to(torch.bfloat16)
           for c in copies[:copies_for(n * k * 2, most=len(copies))]]
    w64 = wbs[0].double()
    rows = [(m, m) for m in rows] + ([(1, K2_HEAD_TIER)] if name == "lm_head" else [])
    for m, tier in rows:
        x = torch.randn((m, k), device=dev, generator=g)
        xb = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
        tiled = m > 4
        if tiled:
            got = qmatmul_cuda(x, w, True, xb_out=xb)
        else:       # the dispatch's choice at the head's tier, counted as it counts
            global_profile.reset()
            set_path("default")
            got = dispatch_qmatmul(x, w, tier_rows=tier)
            placed = global_profile.tier_summary()
            require(placed == {KERNELS[kname][0]: {"cuda": 1}},
                    f"{kname}: one row at tier_rows {tier} placed {placed}, want the bf16 GEMV")
        again, want = qmatmul_cuda(x, w, True), qmatmul_ref(x, w, True)
        torch.cuda.synchronize()
        case = f"{model}{name} M={m}" + ("" if tiled else f" (tier_rows {tier})") + \
            f" N={n} K={k}"
        require(not tiled or torch.equal(xb.view(torch.int16), x.to(torch.bfloat16).view(
            torch.int16)), f"{kname} {case}: the pre-pass's bf16(x) differs from torch's")
        err, bound = float((got - want).abs().max()), K2_BF16_RTOL * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= bound,
                f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
        require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
        exact = refs.bf16_round(x).double() @ w64.T
        rms, rms_plain = (float((y.double() - exact).square().mean().sqrt()) for y in (got, want))
        del exact
        require(rms <= BF16_RMS_RATIO * rms_plain,
                f"{kname} {case}: rms error vs float64 {rms:.3g} > {BF16_RMS_RATIO} x plain's "
                f"{rms_plain:.3g}")
        t = time_ms(torch, [lambda w_=c: qmatmul_cuda(x, w_, True) for c in copies], 50)
        tp = time_ms(torch, [lambda w_=c: qmatmul_ref(x, w_, True) for c in copies], 10)
        xb16 = x.to(torch.bfloat16)
        lib = time_ms(torch, [lambda wb_=wb: torch.matmul(xb16, wb_.T) for wb in wbs], 20)
        extra = dict(rms_vs_plain=rms / rms_plain if rms_plain else None, mode="bf16")
        if tiled:
            extra["n_split"] = qmatmul_plan(m, n, k, *_fwd_card(dev.index or 0, kind, True),
                                            bf16=True).n_split
        record(kname, case, err, bound, t, tp, m * k * 4 + wbytes + m * n * 4,
               0 if tiled else 2 * m * n * k, lib, LIBRARY_K2_BF16,
               bf16ops=2 * m * n * k if tiled else 0, **extra)
    del wbs, w64


def flip_moves(torch, plain, d):
    """(largest max-abs, largest rms) move of a plain bf16 flash version
    `plain(scale)` when its score scale 1/sqrt(d) moves by FLIP_EPS: where
    the scores' f32 sums of two implementations differ by an ulp, some p
    round to the other bf16 neighbour (a flip), and this is how far such
    flips move the output (tests/test_torch_prefill_bf16.py)."""
    base = plain(1.0 / d ** 0.5)
    moves = [plain((1 + e) / d ** 0.5) - base for e in FLIP_EPS]
    return (max(float(m.abs().max()) for m in moves),
            max(float(m.double().square().mean().sqrt()) for m in moves))


def check_attention_bf16(torch, dev, g, record, shape, model, kv8, s=S,
                         cases=BF16_FLASH_CASES):
    """K3's bf16 form (K9's where kv8) on a 128-row chunk at BF16_FLASH_CASES
    over a random stacked cache, against the plain version of the same
    launch plan (attention.flash_partials_ref(bf16=True) and the combine:
    where the plan splits the prefix, each split's running max starts at its
    first key): two launches bit-equal; max-abs error within
    max(FLASH_BF16_RTOL * max|o|, FLIP_MARGIN x flip_moves), rms error
    against a float64 evaluation of the same roundings (q and p to bf16) at
    most BF16_RMS_RATIO x max(the plain version's, the flips' rms move). The
    distance from the unsplit function (JAX's running max from key 0) is
    recorded. A cache of `s` positions, the chunks at `cases`. Bound: one
    bf16 product per dot. Library: bf16
    scaled_dot_product_attention(enable_gqa=True) with a boolean causal
    mask (K9: on the cache rows dequantized to bf16 outside the timed
    window)."""
    from zgml_tpu_torch.ops import attention as A
    from zgml_tpu_torch.quant.kv_cache import dequantize
    n_layers, hq, hkv, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kv8:
        kc = torch.randint(-127, 128, (n_layers, hkv, s, hd), dtype=torch.int8, device=dev,
                           generator=g)
        vc = torch.randint(-127, 128, (n_layers, hkv, s, hd), dtype=torch.int8, device=dev,
                           generator=g)
        ks = torch.rand((n_layers, hkv, s), device=dev, generator=g) * 0.01 + 0.01
        vs = torch.rand((n_layers, hkv, s), device=dev, generator=g) * 0.01 + 0.01
        scales, kname = dict(ks=ks, vs=vs), "flash_attention_q8_bf16"
    else:
        kc = torch.randn((n_layers, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        vc = torch.randn((n_layers, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        scales, kname = {}, "flash_attention_bf16"
    group = A.flash_group(s, kv8)
    for q_off, kv_len in cases:
        q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
        row = (q_off // 128) % n_layers
        if kv8:
            def launch():
                return A.flash_attention_q8_cuda(q, kc, ks, vc, vs, kv_len, q_off, row, True)
        else:
            def launch():
                return A.flash_attention_cuda(q, kc, vc, kv_len, q_off, row, True)
        got, again = launch(), launch()
        plan = A.flash_plan(q, kc, kv_len, q_off, kv8, group)

        def plain(scale=None, exact=False):
            return A.combine_partials_ref(*A.flash_partials_ref(
                q, kc, vc, kv_len, q_off, row, plan=plan, bf16=True, exact=exact, scale=scale,
                **scales))[0]
        want, exact = plain(), plain(exact=True)
        unsplit = (A.flash_attention_q8_ref(q, kc, ks, vc, vs, kv_len, q_off, row, True)
                   if kv8 else A.flash_attention_ref(q, kc, vc, kv_len, q_off, row, True))
        torch.cuda.synchronize()
        case = f"{model}hd={hd} Tq=128 q_offset={q_off} kv_len={kv_len} n_split={plan.n_split}"
        mx = float(want.abs().max())
        move, move_rms = flip_moves(torch, plain, hd)
        err = float((got - want).abs().max())
        bound = max(FLASH_BF16_RTOL * mx, FLIP_MARGIN * move)
        require(bool(torch.isfinite(got).all()) and err <= bound,
                f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g} (flip move "
                f"{move:.3g})")
        require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
        rms, rms_plain = (float((y.double() - exact).square().mean().sqrt()) for y in (got, want))
        require(rms <= BF16_RMS_RATIO * max(rms_plain, move_rms),
                f"{kname} {case}: rms error vs float64 {rms:.3g} > {BF16_RMS_RATIO} x "
                f"max(plain's {rms_plain:.3g}, the flips' {move_rms:.3g})")
        t = time_ms(torch, [launch], 50)
        tp = time_ms(torch, [lambda: plain()], 10)
        if kv8:
            kf = dequantize(kc[row:row + 1, :, :kv_len], ks[row:row + 1, :, :kv_len])
            vf = dequantize(vc[row:row + 1, :, :kv_len], vs[row:row + 1, :, :kv_len])
            kb16, vb16 = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        else:
            kb16, vb16 = kc[row:row + 1, :, :kv_len], vc[row:row + 1, :, :kv_len]
        qb16 = q.to(torch.bfloat16)
        qi = torch.arange(128, device=dev)[:, None] + q_off
        mask = torch.arange(kv_len, device=dev)[None, :] <= qi
        lib_err = float((sdpa(qb16, kb16, vb16, attn_mask=mask, enable_gqa=True).float()
                         - want).abs().max())
        lib = time_ms(torch, [lambda: sdpa(qb16, kb16, vb16, attn_mask=mask, enable_gqa=True)],
                      50)
        live = int(mask.sum())
        pos_bytes = 2 * hkv * (hd + 4) if kv8 else 2 * hkv * hd * 2
        record(kname, case, err, bound, t, tp, 2 * q.numel() * 4 + kv_len * pos_bytes, 0, lib,
               f"scaled_dot_product_attention(enable_gqa=True, boolean causal mask), bf16"
               + (", after an untimed dequant" if kv8 else "")
               + f" (max abs err {lib_err:.2g})", bf16ops=4 * hq * live * hd,
               n_split=plan.n_split, mode="bf16", flip_move=move,
               rms_ratio=rms / max(rms_plain, move_rms),
               vs_unsplit=float((got - unsplit).abs().max()) / mx)


def check_attention_f32kv(torch, dev, g, record, shape, model, s=S, cases=BF16_FLASH_CASES):
    """K3 over f32 K / V (the f32 KV cache's prefill) on a 128-row chunk at
    `cases` (q_offset, kv_len) of a random stacked f32 cache of `s`
    positions, reading a cache row other than 0, in both forms, each
    bit-equal over two launches. The f32 form within F32KV_RTOL * max|o| of
    flash_attention_ref on the same
    f32 K / V (f32 sums in another order; its dots are 3xTF32, bound at
    three TF32 products a dot). The bf16 form against the plain version of
    its launch plan within check_attention_bf16's flip-aware bound, and
    bit-equal to K3's bf16 form run on k.bfloat16(), v.bfloat16() (it
    rounds the staged f32 rows to nearest even and takes that form's plan;
    bound at one bf16 product a dot, with K / V read at 4 bytes). Library:
    f32 scaled_dot_product_attention(enable_gqa=True) with a boolean causal
    mask over the same f32 rows."""
    from zgml_tpu_torch.ops import attention as A
    n_layers, hq, hkv, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kc = torch.randn((n_layers, hkv, s, hd), device=dev, generator=g)
    vc = torch.randn((n_layers, hkv, s, hd), device=dev, generator=g)
    kb, vb = kc.bfloat16(), vc.bfloat16()
    group = A.flash_group(s, False)
    for q_off, kv_len in cases:
        q = torch.randn((1, hq, 128, hd), device=dev, generator=g)
        row = 1 + (q_off // 128) % (n_layers - 1)
        qi = torch.arange(128, device=dev)[:, None] + q_off
        mask = torch.arange(kv_len, device=dev)[None, :] <= qi
        live = int(mask.sum())
        kf, vf = kc[row:row + 1, :, :kv_len], vc[row:row + 1, :, :kv_len]
        nbytes = 2 * q.numel() * 4 + kv_len * 2 * hkv * hd * 4
        for bf16 in (False, True):
            kname = "flash_attention_bf16_f32kv" if bf16 else "flash_attention_f32kv"

            def launch(bf16_=bf16):
                return A.flash_attention_cuda(q, kc, vc, kv_len, q_off, row, bf16_)
            got, again = launch(), launch()
            plan = A.flash_plan(q, kc, kv_len, q_off, False, group if bf16 else None)
            case = (f"{model}hd={hd} Tq=128 q_offset={q_off} kv_len={kv_len} row={row} "
                    f"n_split={plan.n_split}")
            if bf16:
                on_rounded = A.flash_attention_cuda(q, kb, vb, kv_len, q_off, row, True)

                def plain(scale=None, exact=False):
                    return A.combine_partials_ref(*A.flash_partials_ref(
                        q, kc, vc, kv_len, q_off, row, plan=plan, bf16=True, exact=exact,
                        scale=scale))[0]
                want = plain()
                move, _ = flip_moves(torch, plain, hd)
                bound = max(FLASH_BF16_RTOL * float(want.abs().max()), FLIP_MARGIN * move)
            else:
                def plain():
                    return A.flash_attention_ref(q, kc, vc, kv_len, q_off, row)
                want = plain()
                bound = F32KV_RTOL * float(want.abs().max())
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(bool(torch.isfinite(got).all()) and err <= bound,
                    f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
            require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
            extra = {}
            if bf16:
                require(bool(torch.equal(got.view(torch.int32), on_rounded.view(torch.int32))),
                        f"{kname} {case}: not bit-equal to K3's bf16 form on the bf16-rounded "
                        f"K / V")
                extra = dict(bit_equal_on_rounded=True, flip_move=move)
            t = time_ms(torch, [launch], 50)
            tp = time_ms(torch, [plain], 10)
            lib_err = float((sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True) - want)
                            .abs().max())
            lib = time_ms(torch, [lambda: sdpa(q, kf, vf, attn_mask=mask, enable_gqa=True)], 50)
            ops = 4 * hq * live * hd
            record(kname, case, err, bound, t, tp, nbytes, 0, lib,
                   f"scaled_dot_product_attention(enable_gqa=True, boolean causal mask), f32 "
                   f"over the f32 rows (max abs err {lib_err:.2g})",
                   **(dict(bf16ops=ops) if bf16 else dict(tf32ops=F32KV_PASSES * ops)),
                   n_split=plan.n_split, **extra)


def dq_float64_bf16(torch, q, k, v, do, o, lse, kv_len, q_off):
    """K10dq's bf16 form in float64 from the same inputs and roundings:
    bf16(q) in s, bf16(dO) in dP (o and lse the kernel's)."""
    from zgml_tpu_torch.ops import refs
    qb, dob = refs.bf16_round(q), refs.bf16_round(do)
    b, hq, tq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    qg = qb.double().reshape(b, hkv, hq // hkv, tq, d)
    dog = do.double().reshape(qg.shape)
    kd, vd = k.double(), v.double()
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) / d ** 0.5
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_off
    p = torch.where((ki < kv_len) & (ki <= qi),
                    torch.exp(sc - lse.double().reshape(*qg.shape[:-1], 1)),
                    torch.zeros_like(sc))
    del sc
    delta = (dog * o.double().reshape(qg.shape)).sum(-1, keepdim=True)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dob.double().reshape(qg.shape), vd)
    ds = p * (dp - delta) / d ** 0.5
    return torch.einsum("bgrqk,bgkd->bgrqd", ds, kd).reshape(b, hq, tq, d)


def check_training_attention_bf16(torch, dev, g, record):
    """K10f, K10dq and K10dkv in their bf16 forms at TRAIN_FLASH_CASES and
    PAR_TRAIN_FLASH_CASES:
    K10f's O bit-equal to K3's bf16 O, within the flip-aware bound of
    check_attention_bf16 of the plain version of its plan, its LSE within
    REL_BOUND * max; dQ within REL_BOUND * max and its rms error against
    float64 (dq_float64_bf16) at most BF16_RMS_RATIO x the plain version's;
    dK within one bf16 ulp per element and dV within one ulp or FLIP_MARGIN
    x the plain dV's largest move under the score-scale moves (its bf16(p)
    flip), both bit-equal over two launches. Bounds: one bf16 product per
    dot, the dS products (dQ = dS K, dK = dS^T q) two TF32 each. Library:
    aten's efficient attention and its backward in bf16."""
    from zgml_tpu_torch.ops import attention as A
    from zgml_tpu_torch.ops.flash_vjp import (flash_delta_cuda, flash_dkv_cuda, flash_dkv_plan,
                                              flash_dkv_ref, flash_dq_cuda, flash_dq_plan,
                                              flash_dq_ref, flash_fwd_lse_cuda)
    for label, b, hq, hkv, tq, s, hd, kv_len, q_off in (TRAIN_FLASH_CASES
                                                        + PAR_TRAIN_FLASH_CASES):
        q = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        k = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        v = torch.randn((b, hkv, s, hd), device=dev, generator=g).to(torch.bfloat16)
        do = torch.randn((b, hq, tq, hd), device=dev, generator=g)
        args = (q, k, v, kv_len, q_off)
        group = A.flash_group(s, False)
        o, lse = flash_fwd_lse_cuda(*args, bf16=True)
        o3 = A.flash_attention_cuda(*args, 0, True)
        plan = A.flash_plan(q, k, kv_len, q_off, False, group)

        def plain(scale=None):
            return A.combine_partials_ref(*A.flash_partials_ref(
                q, k, v, kv_len, q_off, 0, plan=plan, bf16=True, scale=scale))
        o_r, lse_r = plain()
        bargs = (q, k, v, do, o, lse, kv_len, q_off)
        delta = flash_delta_cuda(do, o)
        dq, (dk, dv) = flash_dq_cuda(*bargs, bf16=True), flash_dkv_cuda(*bargs, bf16=True)
        dq2 = flash_dq_cuda(*bargs, delta=delta, bf16=True)
        dk2, dv2 = flash_dkv_cuda(*bargs, delta=delta, bf16=True)
        dq_r, (dk_r, dv_r) = flash_dq_ref(*bargs, bf16=True), flash_dkv_ref(*bargs, bf16=True)
        torch.cuda.synchronize()
        case = f"{label} Hq={hq} Hkv={hkv} hd={hd} Tq={tq} S={s} kv_len={kv_len} q_offset={q_off}"
        require(torch.equal(o.view(torch.int32), o3.view(torch.int32)),
                f"flash_fwd_bf16 {case}: O is not K3's bf16 O bit for bit")
        move, _ = flip_moves(torch, lambda sc: plain(sc)[0], hd)
        err_o = float((o - o_r).abs().max())
        bound_o = max(FLASH_BF16_RTOL * float(o_r.abs().max()), FLIP_MARGIN * move)
        err_l, bound_l = float((lse - lse_r).abs().max()), REL_BOUND * float(lse_r.abs().max())
        require(err_o <= bound_o and err_l <= bound_l,
                f"flash_fwd_bf16 {case}: o err {err_o:.3g} (bound {bound_o:.3g}), lse err "
                f"{err_l:.3g} (bound {bound_l:.3g})")
        err_q, bound_q = float((dq - dq_r).abs().max()), REL_BOUND * float(dq_r.abs().max())
        require(bool(torch.isfinite(dq).all()) and err_q <= bound_q,
                f"flash_dq_bf16 {case}: max_abs_err {err_q:.3g} > bound {bound_q:.3g}")
        err_k = check_bf16_ulp(torch, dk, dk_r, f"flash_dkv_bf16 {case} dk")
        dv_move = max(float((flash_dkv_ref(*bargs, bf16=True, scale=(1 + e) / hd ** 0.5)[1]
                             .double() - dv_r.double()).abs().max()) for e in FLIP_EPS)
        err_v = check_bf16_ulp(torch, dv, dv_r, f"flash_dkv_bf16 {case} dv",
                               extra=FLIP_MARGIN * dv_move)
        del dv_move
        err_kv = max(err_k, err_v)
        require(torch.equal(dq.view(torch.int32), dq2.view(torch.int32)),
                f"flash_dq_bf16 {case}: two launches differ")
        require(torch.equal(dk.view(torch.int16), dk2.view(torch.int16))
                and torch.equal(dv.view(torch.int16), dv2.view(torch.int16)),
                f"flash_dkv_bf16 {case}: two launches differ")
        exact = dq_float64_bf16(torch, *bargs)
        rms, rms_plain = (float((x.double() - exact).square().mean().sqrt()) for x in (dq, dq_r))
        del exact, dq2, dk2, dv2
        require(rms <= BF16_RMS_RATIO * rms_plain,
                f"flash_dq_bf16 {case}: rms error vs float64 {rms:.3g} > {BF16_RMS_RATIO} x "
                f"plain's {rms_plain:.3g}")
        live = sum(min(kv_len, q_off + i + 1) for i in range(tq))
        heads = b * hq
        qbytes, lbytes = q.numel() * 4, b * hq * tq * 4
        kvbytes = 2 * b * hkv * kv_len * hd * 2
        fwd_lib, bwd_lib, note = efficient_attention(torch, q, k, v, do, kv_len, q_off,
                                                     torch.bfloat16)
        t = time_ms(torch, [lambda: flash_fwd_lse_cuda(*args, bf16=True)], 20)
        tp = time_ms(torch, [lambda: plain()], 5)
        lib = time_ms(torch, [fwd_lib], 20) if fwd_lib else None
        record("flash_fwd_bf16", case + f" n_split={plan.n_split} (O bit-equal to K3's bf16 O; "
               f"lse err {err_l:.3g})", err_o, bound_o, t, tp, qbytes * 2 + lbytes + kvbytes, 0,
               lib, note, bf16ops=4 * heads * live * hd, n_split=plan.n_split, mode="bf16",
               flip_move=move)
        t_delta = time_ms(torch, [lambda: flash_delta_cuda(do, o)], 20)[0]
        t = time_ms(torch, [lambda: flash_dq_cuda(*bargs, delta=delta, bf16=True)], 20)
        tp = time_ms(torch, [lambda: flash_dq_ref(*bargs, bf16=True)], 5)
        lib = time_ms(torch, [bwd_lib], 20) if bwd_lib else None
        bnote = note if bwd_lib is None else (
            "aten._scaled_dot_product_efficient_attention_backward bf16, one call computing "
            "dQ, dK and dV (the same time stands beside K10dq and K10dkv)")
        nq = flash_dq_plan(q, k, kv_len, q_off, True).n_split
        nkv = flash_dkv_plan(q, k, kv_len, q_off, True).n_split
        record("flash_dq_bf16", case + f" n_split={nq} (bit-equal over two launches; rms error "
               f"vs float64 {rms / rms_plain:.2f}x plain's)", err_q, bound_q, t, tp,
               qbytes * 4 + 2 * lbytes + kvbytes, 0, lib, bnote,
               bf16ops=K10DQ_BF16 * heads * live * hd, tf32ops=K10DQ_BF16_TF32 * heads * live * hd,
               n_split=nq, rms_ratio=rms / rms_plain, delta_ms=t_delta, mode="bf16")
        t = time_ms(torch, [lambda: flash_dkv_cuda(*bargs, delta=delta, bf16=True)], 20)
        tp = time_ms(torch, [lambda: flash_dkv_ref(*bargs, bf16=True)], 5)
        record("flash_dkv_bf16", case + f" n_split={nkv} (dK within one bf16 ulp, dV one ulp or "
               f"its flips; bit-equal over two launches)", err_kv[0], err_kv[1], t, tp,
               qbytes * 3 + 2 * lbytes + kvbytes + 2 * heads * s * hd * 2, 0, lib, bnote,
               bf16ops=K10DKV_BF16_BF16 * heads * live * hd,
               tf32ops=K10DKV_BF16_TF32 * heads * live * hd, n_split=nkv, delta_ms=t_delta,
               mode="bf16")


def check_ring_hops(torch, dev, g, record):
    """K10f at cp2_tiny's ring hops (parallel/ring.py): a rank's LONG_PROMPT
    / PAR_RANKS query rows (f32, HQ heads) over one visiting block of as
    many keys (HKV heads of D), the diagonal hop (q_offset 0) and a past
    block (q_offset t, every key live). Its bf16 form over bf16 K/V at the
    ring's key group min(128, t rounded up to 8), within
    check_attention_bf16's flip-aware bound of the plain version of its
    plan; its f32-K/V form (ZGML_TPU_PREFILL_BF16=0: the cp body's f32 K/V)
    within REL_BOUND * max|o| of the plain version; each LSE within
    REL_BOUND * max|lse|, two launches bit-equal. Bound: one bf16 product a
    dot, or three TF32 ones (the f32-K/V form). Library: aten's efficient
    attention forward in bf16, or f32."""
    from zgml_tpu_torch.ops import attention as A
    from zgml_tpu_torch.ops.flash_vjp import flash_fwd_lse_cuda, flash_fwd_lse_ref
    t = LONG_PROMPT // PAR_RANKS
    group = min(128, -(-t // 8) * 8)
    for q_off in (0, t):
        q = torch.randn((1, HQ, t, D), device=dev, generator=g)
        kf, vf = (torch.randn((1, HKV, t, D), device=dev, generator=g) for _ in range(2))
        live = sum(min(t, q_off + i + 1) for i in range(t))
        for bf16 in (True, False):
            k, v = (kf.to(torch.bfloat16), vf.to(torch.bfloat16)) if bf16 else (kf, vf)
            kname = "flash_fwd_bf16" if bf16 else "flash_fwd_f32kv"

            def launch():
                return flash_fwd_lse_cuda(q, k, v, t, q_off, bf16, group)
            (o, lse), (o2, lse2) = launch(), launch()
            plan = A.flash_plan(q, k, t, q_off, False, group if bf16 else None)

            def plain(scale=None):
                if not bf16:
                    return flash_fwd_lse_ref(q, k, v, t, q_off)
                return A.combine_partials_ref(*A.flash_partials_ref(
                    q, k, v, t, q_off, 0, plan=plan, bf16=True, scale=scale))
            o_r, lse_r = plain()
            move = flip_moves(torch, lambda sc: plain(sc)[0], D)[0] if bf16 else 0.0
            torch.cuda.synchronize()
            err = float((o - o_r).abs().max())
            bound = max((FLASH_BF16_RTOL if bf16 else REL_BOUND) * float(o_r.abs().max()),
                        FLIP_MARGIN * move)
            err_l, bound_l = float((lse - lse_r).abs().max()), REL_BOUND * float(lse_r.abs().max())
            case = (f"ring hop Hq={HQ} Hkv={HKV} hd={D} t={t} q_offset={q_off} "
                    f"n_split={plan.n_split}")
            require(bool(torch.isfinite(o).all()) and err <= bound and err_l <= bound_l,
                    f"{kname} {case}: o err {err:.3g} (bound {bound:.3g}), lse err {err_l:.3g} "
                    f"(bound {bound_l:.3g})")
            require(torch.equal(o.view(torch.int32), o2.view(torch.int32))
                    and torch.equal(lse.view(torch.int32), lse2.view(torch.int32)),
                    f"{kname} {case}: two launches differ")
            fwd_lib, _, note = efficient_attention(torch, q, k, v, torch.zeros_like(q), t, q_off,
                                                   torch.bfloat16 if bf16 else None)
            tm = time_ms(torch, [launch], 20)
            tp = time_ms(torch, [plain], 5)
            lib = time_ms(torch, [fwd_lib], 20) if fwd_lib else None
            record(kname, case + f" (lse err {err_l:.3g})", err, bound, tm, tp,
                   2 * q.numel() * 4 + HQ * t * 4 + 2 * HKV * t * D * k.element_size(), 0, lib,
                   note, bf16ops=4 * HQ * live * D if bf16 else 0,
                   tf32ops=0 if bf16 else 3 * 4 * HQ * live * D, n_split=plan.n_split,
                   mode=MODE[kname], flip_move=move)


def check_qmatmul_bwd(torch, dev, g, record, weights, kind, name, n, k):
    """K11 at TRAIN_M rows of g against g @ dequant(W): K2's bound with N in
    K's place; two launches give the same bits (a fixed split, no atomics);
    its rms error against float64 at most K11_RMS_RATIO x the plain
    version's (cuBLAS f32). The library call is torch.matmul on the weight
    dequantized outside the timed window; the bound counts its TF32
    products (TF32_PASSES per f32 product)."""
    from zgml_tpu_torch.ops.qmatmul import (_bwd_card, qmatmul_bwd_cuda, qmatmul_bwd_plan,
                                            qmatmul_bwd_ref)
    copies = weights(kind, n, k, 48_000_000)
    w = copies[0]
    gr = torch.randn((TRAIN_M, n), device=dev, generator=g)
    got, again, want = qmatmul_bwd_cuda(gr, w), qmatmul_bwd_cuda(gr, w), qmatmul_bwd_ref(gr, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bound = 1e-4 * n ** 0.5 + 1e-5 * float(want.abs().max())
    kname = f"{'q4' if kind == 'q4_0' else 'q8'}_matmul_bwd"
    case = f"{name} M={TRAIN_M} N={n} K={k}"
    require(bool(torch.isfinite(got).all()) and err <= bound,
            f"{kname} {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
    require(bool(torch.equal(got, again)), f"{kname} {case}: two launches differ")
    exact = gr.double() @ w.dequant().double()
    rms, rms_plain = (float((x.double() - exact).square().mean().sqrt()) for x in (got, want))
    require(rms <= K11_RMS_RATIO * rms_plain,
            f"{kname} {case}: rms error vs float64 {rms:.3g} > {K11_RMS_RATIO} x plain's "
            f"{rms_plain:.3g}")
    del exact
    t = time_ms(torch, [lambda w_=c: qmatmul_bwd_cuda(gr, w_) for c in copies], 10)
    tp = time_ms(torch, [lambda w_=c: qmatmul_bwd_ref(gr, w_) for c in copies], 4)
    wd = w.dequant()
    lib = time_ms(torch, [lambda: torch.matmul(gr, wd)], 10)
    del wd
    plan = qmatmul_bwd_plan(TRAIN_M, n, k, *_bwd_card(dev.index or 0, kind))
    record(kname, case, err, bound, t, tp,
           TRAIN_M * n * 4 + nbytes_of(w.qs, w.d) + TRAIN_M * k * 4, 0, lib,
           "torch.matmul(g, W) f32, W dequantized outside the timed window",
           tf32ops=TF32_PASSES * 2 * TRAIN_M * n * k, n_split=plan.n_split,
           rms_vs_plain=rms / rms_plain if rms_plain else None)


def copies_for(nbytes: int, total: int = 128_000_000, most: int = 64) -> int:
    """How many copies of a case's inputs make cycling through them find the
    50 MB L2 cold (at least 2, at most `most`)."""
    return max(2, min(most, -(-total // max(1, nbytes))))


def check_rmsnorm(torch, dev, g, record):
    """K12 at RMSNORM_CASES against refs.rmsnorm within RMSNORM_RTOL *
    max|out|, on the vector path of its plan, bit-equal over two launches.
    The library call is torch.nn.functional.rms_norm (the same function,
    never called by the port)."""
    from zgml_tpu_torch.ops.rmsnorm import launch_plan, rmsnorm_cuda, rmsnorm_ref
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for m, d in RMSNORM_CASES:
        xs = [torch.randn((m, d), device=dev, generator=g)
              for _ in range(copies_for(2 * m * d * 4))]
        gamma = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
        plan = launch_plan(xs[0], gamma)
        require(plan.vector, f"rmsnorm M={m} d={d}: the plan takes the scalar path ({plan})")
        got, want = rmsnorm_cuda(xs[0], gamma), rmsnorm_ref(xs[0], gamma)
        again = rmsnorm_cuda(xs[0], gamma)
        torch.cuda.synchronize()
        err, bound = float((got - want).abs().max()), RMSNORM_RTOL * float(want.abs().max())
        require(bool(torch.isfinite(got).all()) and err <= bound,
                f"rmsnorm M={m} d={d}: max_abs_err {err:.3g} > bound {bound:.3g}")
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"rmsnorm M={m} d={d}: two launches differ")
        t = time_ms(torch, [lambda x_=x: rmsnorm_cuda(x_, gamma) for x in xs], 50)
        tp = time_ms(torch, [lambda x_=x: rmsnorm_ref(x_, gamma) for x in xs], 20)
        lib, note = None, "none: this torch has no torch.nn.functional.rms_norm"
        if rms_norm is not None:
            lib_err = float((rms_norm(xs[0], (d,), gamma, 1e-5) - want).abs().max())
            lib = time_ms(torch, [lambda x_=x: rms_norm(x_, (d,), gamma, 1e-5) for x in xs], 50)
            note = f"torch.nn.functional.rms_norm, f32 (max abs err {lib_err:.2g})"
        record("rmsnorm", f"M={m} d={d}", err, bound, t, tp, 2 * m * d * 4 + d * 4,
               4 * m * d, lib, note, plan=plan._asdict())


def chain_cases():
    """(label, steps, shape, side shape) of K13's phase-2 cases: graph_ffn's
    two chains, one case per op (the binary ops with one side input of x's
    shape), and a bias of shape[1] values added to CHAIN_OP_SHAPE."""
    from zgml_tpu_torch.ops.elementwise import BINARY, OPCODES, Step
    cases = [("silu -> mul", [Step("silu"), Step("mul", side=0)], (GRAPH_ROWS, GRAPH_F), None),
             ("add -> sqr", [Step("add", side=0), Step("sqr")], (GRAPH_ROWS, GRAPH_D), None)]
    payload = {"scale": 0.37, "add_scalar": -1.25}
    for op in OPCODES:
        cases.append((op, [Step(op, payload.get(op, 0.0), 0 if op in BINARY else -1)],
                      CHAIN_OP_SHAPE, None))
    cases.append((f"add bias [{CHAIN_OP_SHAPE[1]}]", [Step("add", side=0)], CHAIN_OP_SHAPE,
                  CHAIN_OP_SHAPE[1:]))
    return cases


def chain_library(torch, steps):
    """(the one PyTorch call computing a one-step chain as a function of x
    and the side inputs, its name), or None for a longer chain."""
    if len(steps) != 1:
        return None
    f, op, p = torch.nn.functional, steps[0].op, steps[0].payload
    calls = {"neg": torch.neg, "recip": torch.reciprocal, "sqr": torch.square,
             "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log, "abs": torch.abs,
             "tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu, "silu": f.silu}
    if op in calls:
        return (lambda x, s: calls[op](x)), ("F.silu" if op == "silu"
                                             else f"torch.{calls[op].__name__}")
    if op == "gelu":
        return (lambda x, s: f.gelu(x, approximate="tanh")), 'F.gelu(approximate="tanh")'
    if op in ("scale", "add_scalar"):
        fn = torch.mul if op == "scale" else torch.add
        return (lambda x, s: fn(x, p)), f"torch.{fn.__name__}(x, {p})"
    fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
          "max2": torch.maximum}[op]
    return (lambda x, s: fn(x, s[0])), f"torch.{fn.__name__}"


def kernels_per_call(torch, call, iters: int = 10) -> dict | None:
    """{kernel name: launches per call} over `iters` calls from a profiler
    window (None where every window came back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    call()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        kern = {ev.key: ev.count / iters for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.count}
        if kern:
            return kern
    return None


def check_chains(torch, dev, g, record):
    """K13 against fused_chain_ref on the same inputs: bit-equal (NaN where
    plain is NaN) where every step is exact in IEEE f32, else within
    CHAIN_RTOL * max|out|. A one-step chain's library call is the PyTorch
    call of its op; no library call computes graph_ffn's chains given as
    data. The bias case must run as one kernel a call (its side read in
    place, not materialised)."""
    from zgml_tpu_torch.ops.elementwise import BINARY, fused_chain_cuda, fused_chain_ref
    for label, steps, shape, side_shape in chain_cases():
        n_sides = sum(st.op in BINARY for st in steps)
        side_shape = shape if side_shape is None else side_shape
        n, n_side = math.prod(shape), math.prod(side_shape)
        nbytes = (2 * n + n_sides * n_side) * 4
        sets = []
        for _ in range(copies_for(nbytes, 160_000_000, 8)):
            x = torch.randn(shape, device=dev, generator=g)
            if label in ("log", "sqrt"):
                x = x.abs() + 0.05
            sets.append((x, [torch.randn(side_shape, device=dev, generator=g)
                             for _ in range(n_sides)]))
        x, sides = sets[0]
        got, want = fused_chain_cuda(x, steps, sides), fused_chain_ref(x, steps, sides)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        exact = all(st.op in CHAIN_EXACT for st in steps)
        require(torch.equal(torch.isnan(got), nan), f"fused_chain {label}: NaN where plain has none")
        # equal infinities count as no error (inf - inf would read as NaN)
        err = float(torch.where(got == want, 0.0, got - want)[~nan].abs().max())
        if exact:
            bound = 0.0
            require(torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)),
                    f"fused_chain {label}: not bit-equal to plain (max_abs_err {err:.3g})")
        else:
            bound = CHAIN_RTOL * float(want[~nan].abs().max())
            require(err <= bound, f"fused_chain {label}: max_abs_err {err:.3g} > bound {bound:.3g}")
        extra = {}
        if side_shape != shape:
            per_call = kernels_per_call(torch, lambda: fused_chain_cuda(x, steps, sides))
            require(per_call is not None, f"fused_chain {label}: kernels a call not counted (the "
                                          f"profiler saw no kernel in {PROFILE_TRIES} windows)")
            require(len(per_call) == 1 and "chain_kernel" in next(iter(per_call))
                    and next(iter(per_call.values())) <= 1,
                    f"fused_chain {label}: not one kernel a call: {per_call}")
            extra["kernels_per_call"] = per_call
        t = time_ms(torch, [lambda s_=st: fused_chain_cuda(s_[0], steps, s_[1]) for st in sets],
                    20)
        tp = time_ms(torch, [lambda s_=st: fused_chain_ref(s_[0], steps, s_[1]) for st in sets],
                     10)
        lib, note = None, NO_LIBRARY["chain"]
        library = chain_library(torch, steps)
        if library is not None:
            fn, name = library
            lib_out = fn(x, sides)
            lib_err = float(torch.where(lib_out == want, 0.0, lib_out - want)[~nan].abs().max())
            lib = time_ms(torch, [lambda s_=st: fn(s_[0], s_[1]) for st in sets], 20)
            note = f"{name}, f32 (max abs err against plain {lib_err:.2g})"
        record("fused_chain", f"{label} {list(shape)}" + (" (bit-equal)" if exact else ""), err,
               bound, t, tp, nbytes, 4 * len(steps) * n, lib, note, **extra)


def chain_ulps(torch, got, want):
    """The largest |got - want| over the finite elements in units in the last
    place of their dtype (bf16: 8 significant bits, f16: 11) at max(|got|,
    |want|); infinities and NaNs must match exactly (else inf)."""
    bits, tiny = (8, 2.0 ** -133) if got.dtype == torch.bfloat16 else (11, 2.0 ** -24)
    fin = torch.isfinite(want)
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got[want.isinf()], want[want.isinf()])):
        return math.inf
    a, b = got[fin].double(), want[fin].double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    spacing = torch.ldexp(torch.ones_like(a), (e - bits).to(torch.int32)).clamp_min(tiny)
    return float(((a - b).abs() / spacing).max()) if a.numel() else 0.0


def check_chains_16(torch, dev, g, record, dtype):
    """K13's bf16 / f16 form (each step the torch op on the dtype, rounded
    to it) at chain_cases(): within CHAIN_ULPS_16 ulp per element of
    fused_chain_ref on the same inputs, two launches bit-equal; a one-step
    chain's library call is that op's PyTorch call in the dtype."""
    from zgml_tpu_torch.ops.elementwise import BINARY, counter, fused_chain_cuda, fused_chain_ref
    kname = counter(dtype)
    size = torch.empty((), dtype=dtype).element_size()
    for label, steps, shape, side_shape in chain_cases():
        n_sides = sum(st.op in BINARY for st in steps)
        side_shape = shape if side_shape is None else side_shape
        n, n_side = math.prod(shape), math.prod(side_shape)
        nbytes = (2 * n + n_sides * n_side) * size
        sets = []
        for _ in range(copies_for(nbytes, 160_000_000, 8)):
            x = torch.randn(shape, device=dev, generator=g)
            if label in ("log", "sqrt"):
                x = x.abs() + 0.05
            sets.append((x.to(dtype), [torch.randn(side_shape, device=dev, generator=g).to(dtype)
                                       for _ in range(n_sides)]))
        x, sides = sets[0]
        got, again = fused_chain_cuda(x, steps, sides), fused_chain_cuda(x, steps, sides)
        want = fused_chain_ref(x, steps, sides)
        torch.cuda.synchronize()
        ulps = chain_ulps(torch, got, want)
        require(got.dtype == dtype and torch.equal(got, again) and ulps <= CHAIN_ULPS_16,
                f"{kname} {label}: {ulps} ulps from plain (bound {CHAIN_ULPS_16}), or two "
                f"launches differ")
        fin = torch.isfinite(want)
        err = float((got[fin].float() - want[fin].float()).abs().max())
        t = time_ms(torch, [lambda s_=st: fused_chain_cuda(s_[0], steps, s_[1]) for st in sets],
                    20)
        tp = time_ms(torch, [lambda s_=st: fused_chain_ref(s_[0], steps, s_[1]) for st in sets],
                     10)
        lib, note = None, NO_LIBRARY["chain"]
        library = chain_library(torch, steps)
        if library is not None:
            fn, name = library
            lib = time_ms(torch, [lambda s_=st: fn(s_[0], s_[1]) for st in sets], 20)
            note = f"{name}, {str(dtype).removeprefix('torch.')}"
        record(kname, f"{label} {list(shape)} ({ulps:g} ulp)", err,
               CHAIN_ULPS_16 * float(want[fin].float().abs().max()) * 2.0 ** (
                   -7 if dtype == torch.bfloat16 else -10), t, tp, nbytes,
               4 * len(steps) * n, lib, note, ulps=ulps)


def check_megacalls(torch, dev, g, record, weights):
    """K14 and K15 (bf16 and f32 operands) against their plain versions on
    one random stack of Q4_0 layers, over a random stacked bf16 cache and a
    random stacked f32 cache, at TinyLlama-1.1B's 22 layers and at
    Llama-2-7B's widths over L_7B layers, pos ATTN_POS: x_out, k_cur and
    v_cur within MEGA_REL_PER_LAYER * L * max|out| with f32 operands,
    TAPE_BF16_RTOL * max|out| with bf16 ones; every layer's cache row pos is
    the kernel's own k_cur / v_cur in the cache's dtype (over the bf16 cache
    with f32 operands also within one bf16 ulp of the plain version's row,
    or that bound near 0), and no other row changes. With f32 operands the
    kernel is bit-equal to the per-layer chain over the same cache
    (stackkernel.layer_chain, K7 in its bf16- or f32-cache mode, then K6d:
    every layer's k_cur / v_cur, the final x and the cache); K15's rms
    distance from the plain version is at most MEGA_ROUNDING_RATIO x the
    chain's (the f32 function's) over either cache. Over the bf16 cache
    K15's rms error against stackkernel.stacked_decode_f64 is at most
    MEGA_RMS_RATIO x the plain version's. Over the f32 cache each mode is
    held, in that bound's place, to its bf16-cache mode by a second, exact
    witness: over an f32 cache that holds the bf16 cache's values, it gives
    the bf16-cache launch's x_out / k_cur / v_cur bits (phase B reads the
    rows below pos, and attends the current token in f32, in either form),
    its rows below pos unchanged and row pos its own k_cur / v_cur; its rms
    errors over the random f32 cache are recorded. Two launches give the
    same bits. Each bf16-cache case records the chain's device time
    (chain_ms) and every case the launch's plan (one plan serves both
    caches)."""
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.decode_plan import launch_args, stack_plan
    from zgml_tpu_torch.ops.stackkernel import (PROJECTIONS, StackedLayers, layer_chain,
                                                stacked_decode_cuda, stacked_decode_f64,
                                                stacked_decode_ref)
    from zgml_tpu_torch.ops.tapekernel import Tape, bf16_weight, tape_decode_cuda, tape_decode_ref
    from zgml_tpu_torch.quant.packed import PackedWeight

    def norm(d):
        return 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)

    def rms(a, b):
        return float(torch.sqrt(torch.mean((a.double() - b) ** 2)))

    # kernel name -> (launcher, plain version, keywords, cache dtype)
    runs = {"stack_decode": (stacked_decode_cuda, stacked_decode_ref, {}, torch.bfloat16),
            "tape_decode": (tape_decode_cuda, tape_decode_ref, {"bf16": True}, torch.bfloat16),
            "tape_decode_f32": (tape_decode_cuda, tape_decode_ref, {"bf16": False},
                                torch.bfloat16),
            "stack_decode_f32kv": (stacked_decode_cuda, stacked_decode_ref, {}, torch.float32),
            "tape_decode_f32kv": (tape_decode_cuda, tape_decode_ref, {"bf16": True},
                                  torch.float32),
            "tape_decode_f32_f32kv": (tape_decode_cuda, tape_decode_ref, {"bf16": False},
                                      torch.float32)}
    for model, (n_layers, hq, hkv, hd), f in (("", (L, HQ, HKV, D), FFN_F),
                                              ("7B ", (L_7B, HQ_7B, HKV_7B, D_7B), FFN_F_7B)):
        d, nkv = hq * hd, hkv * hd
        layers = [{"attn_norm": norm(d), "ffn_norm": norm(d),
                   "wqkv": weights("q4_0", (hq + 2 * hkv) * hd, d, 1)[0],
                   "wo": weights("q4_0", d, d, 1)[0],
                   "w_gate_up": weights("q4_0", 2 * f, d, 1)[0],
                   "w_down": weights("q4_0", d, f, 1)[0]} for _ in range(n_layers)]
        stack = StackedLayers(layers, hq, hkv, 1e-5)
        tape = Tape(stack, ())
        plan = stream_plan(launch_args(dev, stack_plan, n_layers, d, hq, hkv, hd, f, S)[0])
        # the weights and norms of every layer, read once per token
        wbytes = sum(nbytes_of(ly[n].qs, ly[n].d) for ly in layers for n in PROJECTIONS) \
            + 2 * n_layers * d * 4
        caches = {}
        for dt in (torch.bfloat16, torch.float32):
            caches[dt] = tuple(torch.randn((n_layers, 1, hkv, S, hd), device=dev,
                                           generator=g).to(dt) for _ in range(2))
        for pos in ATTN_POS:
            x = torch.randn((1, 1, d), device=dev, generator=g)
            cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=dev), hd)
            pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            chains, t_chain = {}, None
            for dt, (ck, cv) in caches.items():
                kc, vc = ck.clone(), cv.clone()
                chain = layer_chain(x, stack, kc, vc, pos_t, cos, sin)
                chains[dt] = (chain, (kc, vc), torch.cat([t.reshape(-1) for t in chain]))
            kt, vt = (c.clone() for c in caches[torch.bfloat16])  # timed in place: row pos
            t_chain = time_ms(torch, [lambda: layer_chain(x, stack, kt, vt, pos_t, cos, sin)], 3)
            del kt, vt
            outs = {}          # bf16-cache launches: the f32-cache modes' witness
            for kname, (kernel, plain, kw, dt) in runs.items():
                ck, cv = caches[dt]
                chain, chain_cache, flat_chain = chains[dt]
                f32kv = dt == torch.float32
                view = stack if kname.startswith("stack") else tape
                bf16 = kw.get("bf16", False)
                kc, vc, kr, vr = ck.clone(), cv.clone(), ck.clone(), cv.clone()
                got = kernel(x, view, kc, vc, pos_t, cos, sin, **kw)
                again = kernel(x, view, kc.clone(), vc.clone(), pos_t, cos, sin, **kw)
                want = plain(x, view, kr, vr, pos, cos, sin, **kw)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"{kname} {model}pos={pos}: two launches differ")
                rel = TAPE_BF16_RTOL if bf16 else MEGA_REL_PER_LAYER * n_layers
                errs = [(float((a - b).abs().max()), rel * float(b.abs().max()))
                        for a, b in zip(got, want)]
                require(all(bool(torch.isfinite(a).all()) for a in got)
                        and all(e <= b for e, b in errs),
                        f"{kname} {model}pos={pos}: (max_abs_err, bound) of x_out, k_cur, v_cur "
                        f"{errs}")
                rows = torch.arange(S, device=dev) != pos
                same = True
                for c, c_r, cur in ((kc, kr, got[1]), (vc, vr, got[2])):
                    row, row_r = c[:, 0, :, pos].double(), c_r[:, 0, :, pos].double()
                    tol = torch.clamp(bf16_ulp(torch, row_r), min=rel * float(row_r.abs().max()))
                    same &= (torch.equal(c[:, 0, :, pos], cur.to(dt))
                             and torch.equal(c[:, :, :, rows], c_r[:, :, :, rows])
                             and (bf16 or f32kv or bool(((row - row_r).abs() <= tol).all())))
                require(same, f"{kname} {model}pos={pos}: a cache row pos is not the kernel's "
                        f"k_cur / v_cur in {dt} (or is off the plain row), or another row "
                        f"changed")
                if not bf16:
                    require(all(torch.equal(a.reshape(b.shape), b) for a, b in zip(got, chain))
                            and torch.equal(kc, chain_cache[0])
                            and torch.equal(vc, chain_cache[1]),
                            f"{kname} {model}pos={pos}: not bit-equal to the per-layer chain "
                            f"K7 + K6d")
                if not f32kv:
                    outs[kname] = got
                else:
                    # the exact witness: the bf16 cache's values held in f32
                    wk, wv = (c.float() for c in caches[torch.bfloat16])
                    seen = kernel(x, view, wk, wv, pos_t, cos, sin, **kw)
                    base = outs[kname.removesuffix("_f32kv")]
                    torch.cuda.synchronize()
                    require(all(torch.equal(a, b) for a, b in zip(seen, base))
                            and all(torch.equal(c[:, :, :, rows], c_b[:, :, :, rows].float())
                                    and torch.equal(c[:, 0, :, pos], cur)
                                    for c, c_b, cur in zip((wk, wv), caches[torch.bfloat16],
                                                           seen[1:])),
                            f"{kname} {model}pos={pos}: over an f32 cache holding the bf16 "
                            f"cache's values, not the bf16-cache launch's bits (or a row is "
                            f"off)")
                    del wk, wv, seen
                exact = stacked_decode_f64(x, stack, ck, cv, pos, cos, sin,
                                           bf16_weight if bf16 else PackedWeight.dequant)
                flat = [torch.cat([t.reshape(-1) for t in out]) for out in (got, want)]
                rms_k, rms_p = rms(flat[0], exact), rms(flat[1], exact)
                near, far = rms(flat[0], flat[1].double()), rms(flat_chain, flat[1].double())
                require(not bf16 or f32kv or rms_k <= MEGA_RMS_RATIO * rms_p,
                        f"{kname} {model}pos={pos}: rms error against float64 {rms_k:.3g} is "
                        f"over {MEGA_RMS_RATIO} x the plain version's {rms_p:.3g}")
                # K15's roundings: nearer its plain version than the f32 function is
                require(not bf16 or near <= MEGA_ROUNDING_RATIO * far,
                        f"{kname} {model}pos={pos}: rms distance from the plain version "
                        f"{near:.3g} is over {MEGA_ROUNDING_RATIO} x the f32 chain's {far:.3g}")
                del exact
                t = time_ms(torch, [lambda: kernel(x, view, kc, vc, pos_t, cos, sin, **kw)], 20)
                tp = time_ms(torch, [lambda: plain(x, view, kr, vr, pos, cos, sin, **kw)],
                             2 if f32kv else 3)
                worst = max(errs, key=lambda eb: eb[0] / eb[1])
                # x in and out, cos/sin, weights and norms, each layer's live
                # cache rows (at the cache's element size), its new row and its
                # k_cur / v_cur out
                esz = 4 if f32kv else 2
                nbytes = (2 * d * 4 + hd * 4 + wbytes
                          + n_layers * ((pos + 1) * 2 * nkv * esz + 2 * nkv * 4))
                ops = n_layers * (2 * d * (hq + 2 * hkv) * hd + 2 * d * d + 6 * d * f
                                  + 4 * hq * pos * hd)
                record(kname, f"{model}L={n_layers} pos={pos} (x_out, k_cur, v_cur)", worst[0],
                       worst[1], t, tp, nbytes, 0 if bf16 else ops, None, NO_LIBRARY["stack"],
                       bf16ops=ops if bf16 else 0, n_layers=n_layers,
                       chain_ms=None if f32kv else t_chain[0], bits_equal_chain=not bf16,
                       rms_err=rms_k, plain_rms_err=rms_p,
                       bits_equal_bf16_cache=True if f32kv else None, rounding_ratio=near / far if bf16 and far else None,
                       cache="f32" if f32kv else "bf16", **plan)
                log(f"    {kname} {model}pos={pos}: per-layer chain K7 + K6d "
                    f"{t_chain[0] * 1e3:.1f} us (bf16 cache); rms error vs float64 {rms_k:.3g} "
                    f"(plain {rms_p:.3g}); rms from plain {near:.3g}, the f32 chain's {far:.3g}"
                    + ("; over the bf16 cache's values the bf16-cache launch's bits"
                       if f32kv else ""))
            del chains
        del layers, stack, tape, caches
        torch.cuda.empty_cache()


def greedy_k_split(torch, dev, g, record, kind, copies):
    """K5 on K1's K-split plan (i8_plan kc > 1) on `copies` of one weight:
    for GREEDY_TRIALS rows its id is argmax of K1's split output on the same
    row exactly and the same over two launches; its error, as check_greedy's,
    is how far the plain logit of its id lies below the plain maximum. The
    bound is K1's split bytes (x, the weight, the id)."""
    from zgml_tpu_torch.ops.qmatmul import (greedy_cuda, greedy_ref, i8_plan, qmatmul_i8_cuda,
                                            qmatmul_i8_ref)
    w = copies[0]
    plan = i8_plan(1, w.n, w.k, kind, torch.cuda.get_device_properties(dev).multi_processor_count)
    kname = NAME["greedy", kind] + "_ksplit"
    case = f"N={w.n} K={w.k} (K-split, kc={plan.kc}), {GREEDY_TRIALS} rows"
    require(plan.kc > 1, f"{kname} {case}: the plan is not the K-split form")
    lost = []
    for _ in range(GREEDY_TRIALS):
        x = torch.randn((1, w.k), device=dev, generator=g)
        ids = [int(greedy_cuda(x, w)[0]), int(greedy_cuda(x, w)[0])]
        y = qmatmul_i8_cuda(x, w)[0]
        y_ref = qmatmul_i8_ref(x, w)[0]
        torch.cuda.synchronize()
        require(ids[0] == ids[1] == int(torch.argmax(y)),
                f"{kname} {case}: ids {ids} over two launches, argmax of K1's split output "
                f"{int(torch.argmax(y))}")
        lost.append((float(y_ref.max() - y_ref[ids[0]]), REL_BOUND * float(y_ref.abs().max())))
    require(all(e <= b for e, b in lost),
            f"{kname} {case}: (max(plain) - plain[id], bound) per row {lost}")
    err, bound = max(lost, key=lambda eb: eb[0] / eb[1])
    t = time_ms(torch, [lambda w_=c: greedy_cuda(x, w_) for c in copies], 20)
    tp = time_ms(torch, [lambda w_=c: greedy_ref(x, w_) for c in copies], 4)
    record(kname, case + ": ids == argmax(K1 split) over two launches; error = max(plain) - "
           "plain[id]", err, bound, t, tp, w.k * 4 + nbytes_of(w.qs, w.d) + 8, 0, None,
           NO_LIBRARY["greedy"], i8ops=2 * w.n * w.k,
           plan=dict(kc=plan.kc, tr=plan.tr, S=plan.S, stages=plan.stages,
                     slot_bytes=plan.slot_bytes, xg=plan.xg, smem_bytes=plan.smem_bytes))


def check_wide(torch, dev, g, record, weights):
    """ROADMAP B.6's two shapes, which the JAX kernels take and the port's
    plans refused before: K1q8 on a 70B-shaped Q8_0 w_down (N 8192, K
    28,672) at M = 1 and 32, its K-split form (i8_plan kc > 1): within
    REL_BOUND * max|y| of plain, bit-equal over two launches, its own int8
    activations the pre-pass's; K5 on that split form on the same weight
    (K5q8) and on a Q4_0 weight of K 51,072 (WIDE_GREEDY_Q4, K5q4): ids
    equal to argmax of K1's split output (greedy_k_split); and K14 at 80
    layers of the 70B width
    (WIDE_STACK), the layers' pointer table read from global memory, its 80
    table rows pointing at two layers' weights (~1 GB; each layer's weights
    still stream once a layer): within MEGA_REL_PER_LAYER * 80 * max|out| of
    plain, bit-equal to the per-layer chain K7 + K6d and over two launches."""
    from zgml_tpu_torch.ops import refs
    from zgml_tpu_torch.ops.decode_plan import launch_args, stack_act_bytes, stack_plan
    from zgml_tpu_torch.ops.qmatmul import (i8_plan, qmatmul_i8_cuda, qmatmul_i8_ref,
                                            quantize_act_ref)
    from zgml_tpu_torch.ops.stackkernel import (PROJECTIONS, StackedLayers, layer_chain,
                                                stacked_decode_cuda, stacked_decode_ref)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, k = WIDE_DOWN
    copies = weights("q8_0", n, k)
    w = copies[0]
    wbytes = nbytes_of(w.qs, w.d)
    for m in (1, 32):
        plan = i8_plan(m, n, k, "q8_0", sms)
        case = f"70B w_down M={m} N={n} K={k} (K-split, kc={plan.kc})"
        require(plan.kc > 1, f"q8_matmul_i8 {case}: the plan is not the K-split form")
        x = torch.randn((m, k), device=dev, generator=g)
        rq, rs = quantize_act_ref(x)
        act = (torch.empty_like(rq), torch.empty_like(rs))
        got, again = qmatmul_i8_cuda(x, w, act_out=act), qmatmul_i8_cuda(x, w)
        want = qmatmul_i8_ref(x, w)
        torch.cuda.synchronize()
        err, bound = float((got - want).abs().max()), REL_BOUND * float(want.abs().max())
        require(torch.equal(act[0], rq)
                and torch.equal(act[1].view(torch.int32), rs.view(torch.int32)),
                f"q8_matmul_i8 {case}: the kernel's own activations differ from plain")
        require(bool(torch.isfinite(got).all()) and err <= bound,
                f"q8_matmul_i8 {case}: max_abs_err {err:.3g} > bound {bound:.3g}")
        require(torch.equal(got, again), f"q8_matmul_i8 {case}: two launches differ")
        t = time_ms(torch, [lambda w_=c: qmatmul_i8_cuda(x, w_) for c in copies], 20)
        tp = time_ms(torch, [lambda w_=c: qmatmul_i8_ref(x, w_) for c in copies], 4)
        record("q8_matmul_i8", case, err, bound, t, tp, m * k * 4 + wbytes + m * n * 4, 0, None,
               NO_LIBRARY["q8"], i8ops=2 * m * n * k,
               plan=dict(kc=plan.kc, tr=plan.tr, S=plan.S, stages=plan.stages,
                         slot_bytes=plan.slot_bytes, xg=plan.xg, pis=plan.pis,
                         smem_bytes=plan.smem_bytes))
    greedy_k_split(torch, dev, g, record, "q8_0", copies)
    del copies, w
    greedy_k_split(torch, dev, g, record, "q4_0", weights("q4_0", *WIDE_GREEDY_Q4))
    n_layers, d, hq, hkv, hd, f, pos = WIDE_STACK
    nkv = hkv * hd
    plan, _, _ = launch_args(dev, stack_plan, n_layers, d, hq, hkv, hd, f, S)
    require(plan.act_bytes == stack_act_bytes(n_layers, d, hq, hkv, hd, f, S, plan.grid,
                                              table=False),
            "stack_decode 70B: the plan stages the pointer table")

    def norm():
        return 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    two = [{"attn_norm": norm(), "ffn_norm": norm(),
            "wqkv": weights("q4_0", (hq + 2 * hkv) * hd, d, 1)[0],
            "wo": weights("q4_0", d, d, 1)[0], "w_gate_up": weights("q4_0", 2 * f, d, 1)[0],
            "w_down": weights("q4_0", d, f, 1)[0]} for _ in range(2)]
    stack = StackedLayers([two[li % 2] for li in range(n_layers)], hq, hkv, 1e-5)
    wbytes = n_layers * (sum(nbytes_of(two[0][p].qs, two[0][p].d) for p in PROJECTIONS)
                         + 2 * d * 4)
    ck = torch.randn((n_layers, 1, hkv, S, hd), device=dev, generator=g).to(torch.bfloat16)
    cv = torch.randn((n_layers, 1, hkv, S, hd), device=dev, generator=g).to(torch.bfloat16)
    x = torch.randn((1, 1, d), device=dev, generator=g)
    cos, sin = refs.rope_cos_sin(torch.tensor([pos], device=dev), hd)
    pos_t = torch.tensor([pos], dtype=torch.int32, device=dev)
    case = f"70B L={n_layers} (two layers' weights) pos={pos}, table in global memory"
    kc, vc, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    got = stacked_decode_cuda(x, stack, kc, vc, pos_t, cos, sin)
    again = stacked_decode_cuda(x, stack, ck.clone(), cv.clone(), pos_t, cos, sin)
    chain = layer_chain(x, stack, k2, v2, pos_t, cos, sin)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"stack_decode {case}: two launches differ")
    require(all(torch.equal(a.reshape(c.shape), c) for a, c in zip(got, chain))
            and torch.equal(kc, k2) and torch.equal(vc, v2),
            f"stack_decode {case}: not bit-equal to the per-layer chain K7 + K6d")
    del k2, v2, chain
    kr, vr = ck.clone(), cv.clone()
    want = stacked_decode_ref(x, stack, kr, vr, pos, cos, sin)
    torch.cuda.synchronize()
    rel = MEGA_REL_PER_LAYER * n_layers
    errs = [(float((a - b).abs().max()), rel * float(b.abs().max())) for a, b in zip(got, want)]
    require(all(bool(torch.isfinite(a).all()) for a in got) and all(e <= b for e, b in errs),
            f"stack_decode {case}: (max_abs_err, bound) of x_out, k_cur, v_cur {errs}")
    t = time_ms(torch, [lambda: stacked_decode_cuda(x, stack, kc, vc, pos_t, cos, sin)], 10)
    t_chain = time_ms(torch, [lambda: layer_chain(x, stack, kc, vc, pos_t, cos, sin)], 3)
    tp = time_ms(torch, [lambda: stacked_decode_ref(x, stack, kr, vr, pos, cos, sin)], 2)
    worst = max(errs, key=lambda eb: eb[0] / eb[1])
    nbytes = (2 * d * 4 + hd * 4 + wbytes
              + n_layers * ((pos + 1) * 2 * nkv * 2 + 2 * nkv * 4))
    ops = n_layers * (2 * d * (hq + 2 * hkv) * hd + 2 * d * d + 6 * d * f + 4 * hq * pos * hd)
    record("stack_decode", case, worst[0], worst[1], t, tp, nbytes, ops, None,
           NO_LIBRARY["stack"], n_layers=n_layers, chain_ms=t_chain[0], bits_equal_chain=True,
           table="global", **stream_plan(plan))
    log(f"    stack_decode 70B: per-layer chain K7 + K6d {t_chain[0] * 1e3:.1f} us")
    del two, stack, ck, cv, kc, vc, kr, vr
    torch.cuda.empty_cache()


def preset(name: str):
    """The model of a path: bench.py's presets, at its max_seq_len 2048."""
    import dataclasses

    from zgml_tpu_torch.utils.synthetic import LLAMA2_7B, TINYLLAMA_1_1B
    cfg = {"tinyllama-1.1b": TINYLLAMA_1_1B, "llama2-7b": LLAMA2_7B}[name]
    return dataclasses.replace(cfg, max_seq_len=2048)


def model_path(name: str, kind: str) -> pathlib.Path:
    import shutil

    from zgml_tpu_torch.io.gguf import GGMLType
    from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
    path = ROOT / ".bench_cache" / f"{name}-{kind}-seed{SEED}-std{WEIGHT_STD}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(path.parent).free
        t0 = time.perf_counter()
        write_synthetic_llama_gguf(str(path), preset(name), quant=GGMLType[kind.upper()],
                                   seed=SEED, scale=WEIGHT_STD)
        log(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s ({free / 1e9:.1f} GB free before)")
    else:
        log(f"  reusing {path.name}")
    return path


def top2_gap(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def set_path(name: str):
    """Set the JAX flags of a path (PATHS, or TRAIN_FLAGS for a training
    path with its own) in this process (the port reads them at call time)."""
    paths = {**PATHS, **TRAIN_FLAGS}
    for flags in paths.values():
        for k in flags:
            os.environ.pop(k, None)
    os.environ.update(paths[name])


def shallow_model(model, n_layers: int):
    """The model's first n_layers layers at full width (the same weight
    tensors, no copy; no megacall view), for SHALLOW_PATHS."""
    import dataclasses

    from zgml_tpu_torch.models.llama import LlamaModel
    params = {k: v for k, v in model.params.items() if k not in ("layers_stacked", "layers_tape")}
    params["layers"] = model.params["layers"][:n_layers]
    return LlamaModel(dataclasses.replace(model.cfg, n_layers=n_layers), params)


def write_ggufs():
    """GGUF_FILES and mixed_tiny's GGUF, each where .bench_cache lacks it
    (the target of the process main starts before phase 2)."""
    for name, kind in GGUF_FILES:
        model_path(name, kind)
    mixed_model_path()


def load_model(torch, dev, name: str, kind: str):
    from zgml_tpu_torch.io.llama_loader import load_llama
    path = model_path(name, kind)
    t0 = time.perf_counter()
    model, gf = load_llama(str(path), device=dev)
    gf.close()
    torch.cuda.synchronize()
    require(all(ly[w].kind == kind for ly in model.params["layers"]
                for w in ("wqkv", "wo", "w_gate_up", "w_down"))
            and model.params["lm_head"].kind == kind,
            f"{path.name}: the loaded weights are not all {kind}")
    log(f"  loaded {path.name} in {time.perf_counter() - t0:.1f} s: {model.cfg}")
    return model


def path_launches(name, kernels, decode=None, tiers=None):
    """The placement counts since the last reset (or `tiers`, a rank's) as
    {kernel: launches}, after the rule of every path: each of `kernels`
    launched, no other kernel and no plain version; `decode` {kernel:
    launches per decode token} adds exact counts."""
    from zgml_tpu_torch.runtime.profile import global_profile
    tiers = global_profile.tier_summary() if tiers is None else tiers
    launches = {k: tiers.get(counter, {}).get("cuda", 0) for k, (counter, _, _) in KERNELS.items()}
    plain = {op: t["ref"] for op, t in tiers.items() if t.get("ref")}
    require(all(launches[k] > 0 for k in kernels),
            f"[{name}] a kernel of the path never launched: {launches}")
    require(all(n == 0 for k, n in launches.items() if k not in kernels),
            f"[{name}] a kernel of another path launched: {launches}")
    require(not plain, f"[{name}] plain tier ran on the path: {plain}")
    steps = global_profile.counters["decode_tokens"]
    for k, per_token in (decode or {}).items():
        require(launches[k] == per_token * steps,
                f"[{name}] {k} launched {launches[k]} times for {steps} decode tokens x "
                f"{per_token}")
    return launches, tiers


def end_to_end(torch, model, prompts, name, summary):
    """Drive one path through the engine; returns (engine, launches, the
    batch-4 engine or None). prompts: the three greedy prompts, then the
    long prompt and the batch-4 prompts by their length (used by LONG_PATHS
    and BATCH4_PATHS)."""
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.sampling import SamplingParams

    set_path(name)
    greedy, long_prompt = prompts[:3], prompts[3]
    prompt4 = prompts[4][BATCH4_PATHS[name]] if name in BATCH4_PATHS else None
    cache = PATH_CACHE.get(name, "bf16")
    eng = LlamaEngine(model, prefill_chunk=128, cache_dtype=cache)
    # the sampled request's engine prefills in chunks of SAMPLED_CHUNK rows, as
    # a latency-bound server may: its 7-token prompt runs `_layer_step` at <=
    # 32 rows (K1, and K6b / K6a for the FFN), which a 128-row chunk never does
    sampled = (LlamaEngine(model, prefill_chunk=SAMPLED_CHUNK, cache_dtype=cache,
                           sampling=SamplingParams(temperature=0.8))
               if name in PATH_SAMPLED else None)
    eng4 = (LlamaEngine(model, batch=4, prefill_chunk=128, cache_dtype=cache)
            if name in BATCH4_PATHS else None)
    vocab = model.cfg.vocab_size

    torch.cuda.synchronize()
    global_profile.reset()
    outs, labels = [], []
    for p in greedy:
        eng.reset()
        outs.append(eng.generate(p, 32))
        labels.append(f"prompt {len(p):>4} tokens, greedy")
    if sampled is not None:
        outs.append(sampled.generate(greedy[0], 32))
        labels.append(f"prompt {len(greedy[0]):>4} tokens, sampled T=0.8")
    if name in LONG_PATHS:
        eng.reset()
        outs.append(eng.generate(long_prompt, 32))
        labels.append(f"prompt {len(long_prompt):>4} tokens, greedy")
    out4 = None
    if eng4 is not None:
        tok = torch.argmax(eng4.prefill(prompt4), dim=-1)
        out4 = torch.cat([tok[None], eng4.decode_n(tok, 31)]).T.tolist()
        outs.extend(out4)
        labels.extend(f"batch 4 row {r}, prompt {prompt4.shape[1]} tokens, greedy"
                      for r in range(4))
    torch.cuda.synchronize()
    # the megacall once per decode token (greedy decode_n and the sampled
    # request's step logits alike), or K7 with the FFN inside once a layer
    per_token = ({MEGA_PATHS[name]: 1} if name in MEGA_PATHS else
                 {LAYER_PATHS[name]: model.cfg.n_layers} if name in LAYER_PATHS else None)
    launches, tiers = path_launches(name, PATH_KERNELS[name], per_token)
    log(f"  [{name}] {len(outs)} requests answered (cache {cache}); placement: {tiers}")
    if "rmsnorm" in PATH_KERNELS[name]:
        # K12 at both norms of every layer of each prefill chunk (any size:
        # `_layer_step`) and at each head call (a chunk's, a decode step's);
        # batch-1 decode layers norm inside K7 and K6
        chunks = sum(-(-len(p) // 128) for p in greedy)
        chunks += -(-len(greedy[0]) // SAMPLED_CHUNK) if sampled is not None else 0
        steps = global_profile.counters["decode_tokens"]
        want = chunks * (2 * model.cfg.n_layers + 1) + steps
        require(launches["rmsnorm"] == want,
                f"[{name}] K12 launched {launches['rmsnorm']} times, want {want} ({chunks} "
                f"chunks x {2 * model.cfg.n_layers + 1} + {steps} decode heads)")
    for out, label in zip(outs, labels):
        require(len(out) == 32 and all(0 <= t < vocab for t in out),
                f"[{name}] {label} gave {out}")
        log(f"  [{name}] {label} -> {out}")
    del sampled

    entry = dict(flags=PATHS[name], model=PATH_MODEL[name], layers=model.cfg.n_layers,
                 cache=cache, launches=launches,
                 placement=tiers, outputs=outs,
                 **against_plain(torch, eng, greedy[0], outs[0], name, "request 1"))
    if eng4 is not None:
        entry["batch4"] = against_plain(torch, eng4, prompt4, out4, name, "the batch-4 request")
    summary.setdefault("e2e", {})[name] = entry
    return eng, launches, eng4


def megacall_f32_request(torch, model, prompt, name, summary):
    """stack_tiny's or tape_tiny's first request (`prompt`, 32 greedy
    tokens) once more from an engine over the f32 KV cache, the placement
    counts set to 0 just before it: the megacall's f32-cache mode exactly
    once per decode token, MEGA_F32_KERNELS, no other kernel and no plain
    version; then against force_ref() as every path's first request
    (against_plain). Returns the launches."""
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    label, mega = MEGA_F32_PATHS[name]
    set_path(name)
    try:
        eng = LlamaEngine(model, prefill_chunk=128, cache_dtype="f32")
        torch.cuda.synchronize()
        global_profile.reset()
        out = eng.generate(prompt, 32)
        torch.cuda.synchronize()
        launches, tiers = path_launches(label, MEGA_F32_KERNELS + (mega,), {mega: 1})
        require(len(out) == 32 and all(0 <= t < model.cfg.vocab_size for t in out),
                f"[{label}] the request gave {out}")
        log(f"  [{label}] prompt {len(prompt)} tokens, greedy, over the f32 cache -> {out}; "
            f"placement: {tiers}")
        summary.setdefault("e2e", {})[label] = dict(
            flags=PATHS[name], model=PATH_MODEL[name], layers=model.cfg.n_layers, cache="f32",
            launches=launches, placement=tiers, outputs=[out],
            **against_plain(torch, eng, prompt, out, name, "request 1 over the f32 cache"))
    finally:
        set_path("default")
    return launches


def modules_phase(torch, dev, models, card, summary):
    """Phase 5, the modules without a kernel of their own, on the card's
    machine: the native host codecs (loaded, and their Q4_0 / Q8_0 bytes of
    Llama-2-7B's layer-0 w_gate_up rows bit-equal to the numpy codecs', each
    timed); the packed checkpoint (Llama-2-7B written from the loaded model,
    loaded back and the GGUF loaded once more, both host walls printed, the
    packed model's planes and the logits of one PACKED_PROMPT-token prefill
    chunk bit-equal to the GGUF model's; the file deleted); the roofline of
    llama2_7b at ROOFLINE_KV over the bf16 cache with the bandwidth measured
    here, beside that path's tg32; and the conformance sweep at
    CONFORMANCE_MODELS' dims, every entry ok and its kernel call placed on
    `cuda` with no `ref` count."""
    from zgml_tpu_torch import native
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.io.packed_ckpt import load_packed_llama, save_packed_llama
    from zgml_tpu_torch.quant import blocks
    from zgml_tpu_torch.quant.packed import PackedWeight
    from zgml_tpu_torch.runtime.conformance import render, run_conformance
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.roofline import roofline
    out = summary.setdefault("modules", {})
    set_path("default")
    m7 = models["llama2-7b", "q4_0"]

    t0 = time.perf_counter()
    loaded = native.available()
    out["native"] = dict(loaded=loaded, library=str(native.library_path()),
                         load_s=time.perf_counter() - t0)
    log(f"  native host library loaded: {loaded} ({native.library_path().name}, "
        f"{out['native']['load_s']:.1f} s with the g++ build)")
    require(loaded, "the native host library (g++ -fopenmp, zgml_tpu_torch/native) did not "
            "build or load on the card's machine")
    w = m7.params["layers"][0]["w_gate_up"].dequant().cpu().numpy()
    for kind in ("q4_0", "q8_0"):
        quantize = getattr(blocks, f"quantize_{kind}")
        t0 = time.perf_counter()
        nat = quantize(w)
        t_nat = time.perf_counter() - t0
        os.environ["ZGML_TPU_NATIVE"] = "0"
        try:
            t0 = time.perf_counter()
            ref = quantize(w)
            t_np = time.perf_counter() - t0
        finally:
            os.environ.pop("ZGML_TPU_NATIVE")
        require(np.array_equal(nat, ref), f"native quantize_{kind} of Llama-2-7B's w_gate_up "
                f"rows differs from the numpy codec's")
        out["native"][kind] = dict(rows=w.shape[0], k=w.shape[1], native_s=t_nat, numpy_s=t_np)
        log(f"  native quantize_{kind} of Llama-2-7B's layer-0 w_gate_up {tuple(w.shape)}: "
            f"bit-equal to numpy; host wall native {t_nat:.3f} s, numpy {t_np:.3f} s")
    del w

    path = ROOT / ".bench_cache" / "llama2-7b-q4_0-seed0.packed.safetensors"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        save_packed_llama(str(path), m7)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pm = load_packed_llama(str(path), device=dev)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gm, gf = load_llama(str(model_path("llama2-7b", "q4_0")), device=dev)
        gf.close()
        torch.cuda.synchronize()
        gguf_s = time.perf_counter() - t0
        size = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)

    def leaves(params):
        for ly in params["layers"]:
            for key in sorted(ly):
                v = ly[key]
                yield from ((v.qs, v.d) if isinstance(v, PackedWeight) else (v,))
        for key in ("tok_embd", "out_norm", "lm_head"):
            v = params[key]
            yield from ((v.qs, v.d) if isinstance(v, PackedWeight) else (v,))
    require(pm.cfg == gm.cfg and all(a.dtype == b.dtype and torch.equal(a, b)
                                     for a, b in zip(leaves(pm.params), leaves(gm.params))),
            "the packed Llama-2-7B's config or planes differ from the GGUF load's")
    prompt = np.random.default_rng(SEED).integers(0, gm.cfg.vocab_size, PACKED_PROMPT)
    lg = LlamaEngine(gm, prefill_chunk=PACKED_PROMPT).prefill(prompt)
    lp = LlamaEngine(pm, prefill_chunk=PACKED_PROMPT).prefill(prompt)
    torch.cuda.synchronize()
    require(torch.equal(lg, lp), "the packed Llama-2-7B's prefill logits differ from the GGUF "
            "model's")
    out["packed"] = dict(bytes=size, save_s=save_s, load_packed_s=packed_s, load_gguf_s=gguf_s,
                         logits_bit_equal=True)
    log(f"  packed checkpoint of Llama-2-7B Q4_0 ({size / 1e9:.2f} GB): written in "
        f"{save_s:.1f} s; host wall of the load: packed {packed_s:.2f} s, GGUF {gguf_s:.2f} s "
        f"(both from the page cache); planes and a {PACKED_PROMPT}-token prefill's logits "
        f"bit-equal  [{card}]")
    del pm, gm, lg, lp
    torch.cuda.empty_cache()

    r = roofline(m7, kv_len=ROOFLINE_KV, cache_dtype="bf16")
    tg = summary.get("rates", {}).get("llama2_7b", {}).get("tg32_tok_s")
    out["roofline_llama2_7b"] = dict(r, kv_len=ROOFLINE_KV, tg32_tok_s=tg)
    log(f"  roofline llama2_7b at kv_len {ROOFLINE_KV} (bf16 cache): measured bandwidth "
        f"{r['hbm_bandwidth_GBs']:.1f} GB/s (saxpy, read + write), {r['weight_bytes']} weight "
        f"+ {r['kv_bytes']} KV bytes a token -> {r['achievable_tok_s']:.1f} tok/s achievable; "
        f"the path's tg32 {tg if tg is None else round(tg, 1)} tok/s"
        + (f" ({100 * tg / r['achievable_tok_s']:.1f}% of it)" if tg else "") + f"  [{card}]")

    for name in CONFORMANCE_MODELS:
        t0 = time.perf_counter()
        res = run_conformance(preset(name), device=dev)
        secs = time.perf_counter() - t0
        log(f"  conformance at {name}'s dims ({secs:.1f} s):\n" + render(res))
        bad = [r_["name"] for r_ in res if not r_["ok"]]
        require(not bad, f"conformance at {name}'s dims: entries over tolerance {bad}")
        off = {r_["name"]: r_["placement"] for r_ in res
               if not any(t.get("cuda") for t in r_["placement"].values())
               or any(t.get("ref") for t in r_["placement"].values())}
        require(not off, f"conformance at {name}'s dims: entries whose call ran no kernel or a "
                f"plain version: {off}")
        out.setdefault("conformance", {})[name] = dict(seconds=secs, results=res)


def f32_prefill_check(torch, eng, prompt, summary):
    """f32kv_tiny's second prefill: `prompt` under ZGML_TPU_PREFILL_BF16=0
    (K2's f32 form, K3's f32-K/V f32 form in every layer), the placement
    counts set to 0 just before, against the same prefill under force_ref()
    within LOGIT_RTOL * max|logit| (f32 sums in another order over an f32
    cache: no bf16 rounding to flip). Returns the launches."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.profile import global_profile
    name, flags, kernels = F32KV_TINY_F32
    set_path("f32kv_tiny")
    os.environ.update(flags)
    try:
        eng.reset()
        torch.cuda.synchronize()
        global_profile.reset()
        got = eng.prefill(prompt)
        torch.cuda.synchronize()
        launches, tiers = path_launches(name, kernels)
        layers = eng.model.cfg.n_layers
        chunks = -(-len(prompt) // eng.prefill_chunk)
        require(launches["flash_attention_f32kv"] == layers * chunks,
                f"[{name}] K3's f32-K/V form launched {launches['flash_attention_f32kv']} times, "
                f"want {layers * chunks}")
        eng.reset()
        with force_ref():
            want = eng.prefill(prompt)
        torch.cuda.synchronize()
    finally:
        set_path("default")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    require(bool(torch.isfinite(got).all()) and err <= LOGIT_RTOL * scale,
            f"[{name}] prefill logits {err:.4g} from force_ref()'s (bound "
            f"{LOGIT_RTOL * scale:.4g})")
    log(f"  [{name}] {len(prompt)}-token prefill under ZGML_TPU_PREFILL_BF16=0 over the f32 "
        f"cache: placement {tiers}; logits {err:.4g} from force_ref()'s ({err / scale:.3g} of "
        f"max|logit|, bound {LOGIT_RTOL:g})")
    summary.setdefault("e2e", {})[name] = dict(flags=flags, launches=launches, placement=tiers,
                                               logits_err=err, logits_scale=scale)
    return launches


def serve_traffic(vocab: int) -> list[tuple[list[int], int]]:
    """The serving paths' requests: SERVE_REQUESTS (prompt, max_new_tokens),
    prompt lengths and budgets drawn from SEED (one to three chunks)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    news = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, SERVE_REQUESTS)
    return [(rng.integers(0, vocab, int(n)).tolist(), int(m)) for n, m in zip(lens, news)]


def drive_server(serve, reqs) -> tuple[list[list[int]], int]:
    """SERVE_FIRST requests at the start, the others after the
    SERVE_ADMIT_STEP-th step (mid-flight admission, slot reuse), step()
    until admissions drain, then step_burst(SERVE_BURST); returns the
    outputs in submit order and the steps taken."""
    rids = [serve.submit(p, n) for p, n in reqs[:SERVE_FIRST]]
    steps = 0
    while serve.busy():
        if steps == SERVE_ADMIT_STEP:
            rids += [serve.submit(p, n) for p, n in reqs[SERVE_FIRST:]]
        if steps >= SERVE_ADMIT_STEP and not serve.waiting and not serve.prefilling:
            serve.step_burst(SERVE_BURST)
        else:
            serve.step()
        steps += 1
    require(len(rids) == len(reqs), f"the server drained before step {SERVE_ADMIT_STEP}")
    return [serve.requests[r].output for r in rids], steps


def watch_server(torch, serve, gaps: bool):
    """Wrap a server's prefill and decode steps: each request's last prefill
    logits (rid -> [1, V]) and, with gaps, the top-2 gap of every logit row
    it was sampled from, relative to the row's max|logit| (rid -> list)."""
    lasts, rel_gaps = {}, {}
    prefill, decode = serve._prefill_slot, serve._decode_logits

    def rel(lg):
        top = lg.float().topk(2, dim=-1).values
        return ((top[:, 0] - top[:, 1]) / lg.float().abs().amax(dim=-1)).tolist()

    def prefill_spy(tokens, slot, pos, n_valid):
        out = prefill(tokens, slot, pos, n_valid)
        p = serve.prefilling[0]
        if pos + n_valid >= len(p.req.prompt):
            lasts[p.req.rid] = out.clone()
            if gaps:
                rel_gaps[p.req.rid] = rel(out)
        return out

    def decode_spy(tok, pos, active):
        logits = decode(tok, pos, active)
        row_gaps = rel(logits)
        for i, r in enumerate(serve.slots):
            if r is not None:
                rel_gaps[r.rid].append(row_gaps[i])
        return logits
    serve._prefill_slot = prefill_spy
    if gaps:
        serve._decode_logits = decode_spy
    return lasts, rel_gaps


def serving_path(torch, model, reqs, name, summary):
    """A serving path (SERVE_PATHS): the traffic of serve_traffic through one
    ContinuousBatchingEngine(max_batch SERVE_BATCH, prefill_chunk
    SERVE_CHUNK) under drive_server, the placement counts set to 0 just
    before it and read just after: the path's kernels launched, no other
    kernel and no plain version. Then, for each request: (a) its stream
    bit-equal to the same request served alone by a fresh engine of the
    same max_batch and chunk (each row's kernels compute it from that row
    alone at a fixed max_batch); (b) its last prefill logits (into its
    slot) against a batch-1 LlamaEngine prefill of its prompt at the same
    chunk, the largest difference printed, within LOGIT_RTOL * max|logit|;
    (c) its tokens equal those of the same server under force_ref() up to
    the first token whose plain top-2 gap is under STEP_RTOL * max|logit|
    (FLIP_PATHS' rule). Returns the launches."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    cache, kernels = SERVE_PATHS[name]
    set_path("default")

    def server():
        return ContinuousBatchingEngine(model, max_batch=SERVE_BATCH, prefill_chunk=SERVE_CHUNK,
                                        cache_dtype=cache)
    serve = server()
    lasts, _ = watch_server(torch, serve, gaps=False)
    torch.cuda.synchronize()
    global_profile.reset()
    outs, steps = drive_server(serve, reqs)
    torch.cuda.synchronize()
    launches, tiers = path_launches(name, kernels)
    log(f"  [{name}] {len(outs)} requests in {steps} steps (cache {cache}, max_batch "
        f"{SERVE_BATCH}, chunk {SERVE_CHUNK}); placement: {tiers}")
    vocab = model.cfg.vocab_size
    for (p, n), out in zip(reqs, outs):
        require(len(out) == n and all(0 <= t < vocab for t in out),
                f"[{name}] a request of {len(p)} tokens gave {out} for {n}")
    # (a) each request alone, (b) its slot prefill against a batch-1 prefill
    alone_equal, prefill_diffs = [], []
    for rid, ((p, n), out) in enumerate(zip(reqs, outs)):
        alone = server().run([(p, n)])[0]
        alone_equal.append(alone == out)
        ref = LlamaEngine(model, prefill_chunk=SERVE_CHUNK, cache_dtype=cache).prefill(p)
        diff = float((lasts[rid] - ref).abs().max())
        prefill_diffs.append(diff)
        bound = LOGIT_RTOL * float(ref.abs().max())
        require(bool(torch.isfinite(lasts[rid]).all()) and diff <= bound,
                f"[{name}] request {rid}: the slot prefill's logits are {diff:.3g} from a "
                f"batch-1 prefill's (bound {bound:.3g})")
    require(all(alone_equal), f"[{name}] a request's stream differs when served alone: "
            f"{alone_equal}")
    # (c) against the same server under force_ref()
    plain_serve = server()
    with force_ref():
        _, gaps = watch_server(torch, plain_serve, gaps=True)
        ref_outs, _ = drive_server(plain_serve, reqs)
    n_cmp = [next((i for i, gap in enumerate(gaps[rid]) if gap < STEP_RTOL), len(out))
             for rid, out in enumerate(outs)]
    require(all(o[:c] == r[:c] for o, r, c in zip(outs, ref_outs, n_cmp)),
            f"[{name}] tokens differ from force_ref()'s before tokens {n_cmp}")
    log(f"  [{name}] (a) every stream bit-equal to its request served alone: "
        f"{all(alone_equal)}; (b) slot prefill vs batch-1 prefill, largest logit difference "
        f"{max(prefill_diffs):.3g} (bit-equal {max(prefill_diffs) == 0.0}); (c) tokens equal to "
        f"force_ref()'s over the first {n_cmp} (plain top-2 gap bound {STEP_RTOL} of "
        f"max|logit|), all equal: {outs == ref_outs}")
    summary.setdefault("serve", {})[name] = dict(
        cache=cache, max_batch=SERVE_BATCH, prefill_chunk=SERVE_CHUNK, steps=steps,
        requests=[dict(prompt=len(p), max_new_tokens=n) for p, n in reqs],
        launches=launches, placement=tiers, outputs=outs, alone_equal=alone_equal,
        prefill_vs_batch1_max_diff=prefill_diffs, tokens_checked=n_cmp,
        tokens_all_equal_plain=outs == ref_outs)
    return launches


def serving_rates(torch, model, reqs, card, summary):
    """Phase 4: each serving path's rate, all requests' emitted tokens over
    the host wall of drive_server (synchronized), SERVE_RATE_RUNS runs in
    turns, the median; and the device-busy share of 8 serve_decode steps of
    SERVE_BATCH live requests (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    set_path("default")
    walls = {name: [] for name in SERVE_PATHS}
    tokens = {}
    for _ in range(SERVE_RATE_RUNS):
        for name, (cache, _) in SERVE_PATHS.items():
            serve = ContinuousBatchingEngine(model, max_batch=SERVE_BATCH,
                                             prefill_chunk=SERVE_CHUNK, cache_dtype=cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, _ = drive_server(serve, reqs)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            tokens[name] = sum(len(o) for o in outs)
    for name, (cache, _) in SERVE_PATHS.items():
        wall = statistics.median(walls[name])
        rate = tokens[name] / wall
        # 8 decode steps with every slot live and no admission pending
        serve = ContinuousBatchingEngine(model, max_batch=SERVE_BATCH,
                                         prefill_chunk=SERVE_CHUNK, cache_dtype=cache)
        for p, _ in reqs[:SERVE_BATCH]:
            serve.submit(p, 64)
        while serve.prefilling or serve.waiting:
            serve.step()
        busy = None
        for _ in range(PROFILE_TRIES):
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    serve.step()
                torch.cuda.synchronize()
                dwall = time.perf_counter() - t0
            kern = [_self_device_us(ev) for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            if kern:
                busy = sum(kern)
                break
        share = "not measured" if busy is None else busy / (dwall * 1e6)
        log(f"  [{name}] serving rate {rate:.1f} tok/s ({tokens[name]} tokens of "
            f"{SERVE_REQUESTS} requests, median host wall {wall:.3f} s of {SERVE_RATE_RUNS} runs "
            f"in turns); 8 serve_decode steps of {SERVE_BATCH} rows: host wall "
            f"{dwall * 1e3:.2f} ms, device busy "
            + ("not measured" if busy is None else f"{busy / 1e3:.2f} ms ({100 * share:.1f}%)")
            + f"  [{card}]")
        summary.setdefault("rates", {})[name] = dict(
            serve_tok_s=rate, tokens=tokens[name], walls_s=walls[name],
            decode8_wall_us=dwall * 1e6, decode8_busy_us=busy, decode8_busy_share=share,
            card=card)


def kernel_switch_check(torch, model, prompt, summary):
    """The JAX per-op switches on the card (ROADMAP C.3): TinyLlama-1.1B
    Q4_0 under ZGML_TPU_KERNELS_DISABLE=attn_block places no K7 and no plain
    version, and its prefill and SWITCH_STEPS decode steps give the logits of
    the same requests under ZGML_TPU_ATTN_BLOCK=0 bit for bit (the JAX
    package's path for the switch, the same kernels)."""
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    runs = {}
    for label, flags in (("ZGML_TPU_KERNELS_DISABLE=attn_block",
                          {"ZGML_TPU_KERNELS_DISABLE": "attn_block"}),
                         ("ZGML_TPU_ATTN_BLOCK=0", {"ZGML_TPU_ATTN_BLOCK": "0"})):
        set_path("default")
        os.environ.update(flags)
        eng = LlamaEngine(model, prefill_chunk=128)
        global_profile.reset()
        logits = [eng.prefill(prompt)]
        tok = torch.argmax(logits[0], dim=-1)
        for _ in range(SWITCH_STEPS):
            tok, lg = eng.step(tok)
            logits.append(lg)
        torch.cuda.synchronize()
        tiers = global_profile.tier_summary()
        require("attn_block" not in tiers, f"[{label}] K7 placed: {tiers}")
        require(not any(t.get("ref") for t in tiers.values()),
                f"[{label}] plain tier ran: {tiers}")
        runs[label] = (torch.cat(logits), tiers)
    set_path("default")
    (a, ta), (b, tb) = runs.values()
    require(torch.equal(a, b), f"ZGML_TPU_KERNELS_DISABLE=attn_block: logits differ from "
            f"ZGML_TPU_ATTN_BLOCK=0 by {float((a - b).abs().max()):.3g}")
    require(ta == tb, f"the two switches placed different kernels: {ta} / {tb}")
    log(f"  [kernel switch] ZGML_TPU_KERNELS_DISABLE=attn_block: no K7, prefill and "
        f"{SWITCH_STEPS} steps bit-equal to ZGML_TPU_ATTN_BLOCK=0; placement {ta}")
    summary["kernel_switch"] = dict(switch="ZGML_TPU_KERNELS_DISABLE=attn_block",
                                    same_as="ZGML_TPU_ATTN_BLOCK=0", steps=SWITCH_STEPS,
                                    bit_equal=True, placement=ta)


def plain_envelope(torch, eng, prompt, draws=SENS_DRAWS) -> dict:
    """The engine `eng` on `prompt` ([T], or [B, T] on a batch-B engine)
    with the kernels: its prefill logits, the greedy first ids tok0, its
    cache after the prefill (a clone) and position, one decode step of tok0
    from that cache; the same prefill and step under force_ref(), and how far
    the plain path itself moves under SENS_EPS perturbations (the embedding
    rows of the prompt, of tok0, and on a path whose prefill takes the bf16
    forms (ZGML_TPU_PREFILL_BF16) every projection's output, proj_out_probe:
    there the plain path's bf16 and int8 roundings swallow most embedding
    perturbations, PERF.md), `draws` draws each; and the bounds made of them:
    bound_p = max(LOGIT_RTOL x max|plain logit|, SENS_MARGIN x the largest
    prefill move), bound_s the same for the step at STEP_RTOL."""
    from zgml_tpu_torch import config
    from zgml_tpu_torch.ops.dispatch import force_ref
    params = eng.model.params
    embd = params["tok_embd"] if "tok_embd" in params else params["wte"]    # llama, GPT-2

    def moves(run, ids, want, proj_out=False):
        ids = sorted({int(i) for i in np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids)
                      .ravel()})
        rows = embd[ids].clone()
        g = torch.Generator(device=rows.device).manual_seed(SEED)
        moved = []
        with force_ref():
            for _ in range(draws):
                embd[ids] = rows * (1 + SENS_EPS * torch.randn(rows.shape, device=rows.device,
                                                               generator=g))
                with proj_out_probe(torch, g) if proj_out else contextlib.nullcontext():
                    moved.append(float((run() - want).abs().max()))
        embd[ids] = rows
        return moved

    def prefill():
        eng.reset()
        return eng.prefill(prompt)
    logits = prefill()
    tok0 = torch.argmax(logits, dim=-1)
    saved, pos0 = {k: v.clone() for k, v in eng.cache.items()}, eng.pos

    def step():
        for k, v in saved.items():
            eng.cache[k].copy_(v)
        eng.pos = pos0
        return eng.step(tok0)[1]
    env = dict(logits=logits, tok0=tok0, saved=saved, pos=pos0, step=step())
    with force_ref():
        env["step_r"] = step()
    env["sens_s"] = moves(step, tok0, env["step_r"])
    with force_ref():
        env["logits_r"] = prefill()
    env["sens_p"] = moves(prefill, prompt, env["logits_r"])
    env["sens_o"] = (moves(prefill, prompt, env["logits_r"], True) if config.prefill_bf16()
                     else [])
    env["bound_p"] = max(LOGIT_RTOL * float(env["logits_r"].abs().max()),
                         SENS_MARGIN * max(env["sens_p"] + env["sens_o"]))
    env["bound_s"] = max(STEP_RTOL * float(env["step_r"].abs().max()),
                         SENS_MARGIN * max(env["sens_s"]))
    return env


def against_plain(torch, eng, prompt, out, name, label):
    """The request `prompt` ([T], or [B, T] on a batch-B engine) against the
    plain versions of the same path on the card (force_ref()): the prefill
    logits and one decode step from a shared cache, each within
    plain_envelope's bound, and the greedy tokens `out` ([32], or B rows of
    32) equal to the plain path's up to its first small top-2 gap."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    b, vocab = eng.batch, eng.model.cfg.vocab_size
    rows_out = out if b > 1 else [out]
    env = plain_envelope(torch, eng, prompt)
    del env["saved"]
    logits_k, step_k, step_r = env["logits"], env["step"], env["step_r"]
    sens_p, sens_o, sens_s = env["sens_p"], env["sens_o"], env["sens_s"]
    with force_ref():
        eng.reset()
        logits_r = eng.prefill(prompt)
        tok = torch.argmax(logits_r, dim=-1)
        ref_toks = [[int(t)] for t in tok]
        gaps = [[top2_gap(lg)] for lg in logits_r]
        for _ in range(31):
            tok, lg = eng.step(tok)
            for r in range(b):
                ref_toks[r].append(int(tok[r]))
                gaps[r].append(top2_gap(lg[r]))
    torch.cuda.synchronize()
    require(tuple(logits_k.shape) == (b, vocab) and bool(torch.isfinite(logits_k).all()),
            f"[{name}] {label}: prefill logits {tuple(logits_k.shape)} not finite [{b}, {vocab}]")
    scale_p = float(logits_r.abs().max())
    err = float((logits_k - logits_r).abs().max())
    bound = env["bound_p"]
    require(err <= bound, f"[{name}] {label}: prefill logits max_abs_err {err:.4g} > bound "
            f"{bound:.4g} (plain path under {SENS_EPS:g} input perturbations: "
            f"{[f'{v:.3g}' for v in sens_p]}; and of every projection's output: "
            f"{[f'{v:.3g}' for v in sens_o]})")
    scale = float(step_r.abs().max())
    step_err = float((step_k - step_r).abs().max())
    step_bound = env["bound_s"]
    require(bool(torch.isfinite(step_k).all()) and step_err <= step_bound,
            f"[{name}] {label}: decode step from a shared cache max_abs_err {step_err:.4g} > "
            f"bound {step_bound:.4g} (plain path under {SENS_EPS:g} input perturbations: "
            f"{[f'{v:.3g}' for v in sens_s]})")
    # the FLIP_PATHS quantize per decode token beyond K1 (K7-i8 and K6c's
    # pre-passes, the int8 cache), so their tokens are compared up to the first
    # plain top-2 gap under the step bound (relative); the others keep the
    # prefill bound
    gap_bound = bound if name not in FLIP_PATHS else step_bound / scale * scale_p
    n_cmp = [next((i for i, gap in enumerate(gr) if gap < gap_bound), 32) for gr in gaps]
    require(all(o[:n] == r[:n] for o, r, n in zip(rows_out, ref_toks, n_cmp)),
            f"[{name}] {label}: tokens differ before steps {n_cmp}: {rows_out} vs plain "
            f"{ref_toks}")
    log(f"  [{name}] {label} vs force_ref(): prefill logits max_abs_err {err:.4g} "
        f"({err / scale_p:.3g} of max|logit|; bound {bound:.4g}; the plain path moves "
        f"{max(sens_p) / scale_p:.3g} under {SENS_EPS:g} input perturbations"
        + (f", {max(sens_o) / scale_p:.3g} with every projection's output" if sens_o else "")
        + f"); decode step "
        f"from a shared cache {step_err:.4g} ({step_err / scale:.3g}; bound {step_bound:.4g}; "
        f"the plain path moves {max(sens_s) / scale:.3g}); tokens equal over the first "
        f"{n_cmp} of 32 steps (plain top-2 gap bound {gap_bound:.3g}); all equal: "
        f"{rows_out == ref_toks}")
    return dict(logits_err=err, logits_bound=bound, logits_scale=scale_p,
                logits_sensitivity=sens_p, logits_sensitivity_proj_out=sens_o,
                step_err=step_err, step_bound=step_bound,
                step_scale=scale, step_sensitivity=sens_s, tokens_checked=n_cmp,
                tokens_gap_bound=gap_bound, tokens_all_equal=rows_out == ref_toks,
                min_gap=min(min(gr) for gr in gaps))


def corpus_batches(torch, dev, b, t, n):
    """n batches [b, t] of consecutive windows of tests/data/corpus_tokens.npy
    (35632 token ids below 4122, in the repo)."""
    ids = np.load(ROOT / "tests" / "data" / "corpus_tokens.npy").astype(np.int64)
    require(n * b * t <= len(ids), f"the corpus holds {len(ids)} ids, {n * b * t} asked for")
    return [torch.from_numpy(ids[i * b * t:(i + 1) * b * t].reshape(b, t)).to(dev)
            for i in range(n)]


def llama_loss(cfg, merge=None):
    """The JAX training loss of tests/test_training.py:156-160: next-token
    cross entropy of the model's training forward; merge(p) builds the full
    params from the trainable ones (the frozen paths)."""
    from zgml_tpu_torch.models.llama import LlamaModel
    from zgml_tpu_torch.nn.losses import cross_entropy_idx

    def loss(p, x, y):
        return cross_entropy_idx(LlamaModel(cfg, p if merge is None else merge(p))(x)[:, :-1],
                                 y[:, 1:])
    return loss


def frozen(model):
    """(trainable params, merge) of a quantized model: tok_embd and the norms
    train, the quantized projections stay frozen (`_qmm_diff`'s case)."""
    full = model.params       # adam_update returns new tensors: these stay as loaded
    tr = {"tok_embd": full["tok_embd"], "out_norm": full["out_norm"],
          "layers": [{"attn_norm": ly["attn_norm"], "ffn_norm": ly["ffn_norm"]}
                     for ly in full["layers"]]}

    def merge(p):
        return {**full, "tok_embd": p["tok_embd"], "out_norm": p["out_norm"],
                "layers": [{**ly, **t} for ly, t in zip(full["layers"], p["layers"])]}
    return tr, merge


class Trainer:
    """Adam steps as train_supervised takes them (value_and_grad, then
    adam_update at TRAIN_LR) on a list of batches, each batch its own
    input and target."""

    def __init__(self, loss_fn, params, batches):
        from zgml_tpu_torch.optim.adam import adam_init
        self.loss_fn, self.params, self.batches = loss_fn, params, batches
        self.state = adam_init(params)
        self.losses = []

    def step(self, i: int):
        from zgml_tpu_torch.nn.train import value_and_grad
        from zgml_tpu_torch.optim.adam import AdamConfig, adam_update
        x = self.batches[i % len(self.batches)]
        loss, grads = value_and_grad(self.loss_fn, self.params, x, x)
        self.params, self.state = adam_update(self.params, grads, self.state,
                                              AdamConfig(lr=TRAIN_LR))
        self.losses.append(loss)

    @property
    def tokens(self) -> int:
        return self.batches[0].numel()


def train_path(torch, name, trainers, summary, flags="default"):
    """One training path under the JAX flags of PATHS[flags]: each trainer's
    TRAIN_STEPS (batch i at step i) with the placement counts set to 0 just
    before and read just after; the path's kernels must launch, no other
    kernel and no plain version may run, and each trainer's loss on batch 0
    must fall from its first step to after its last."""
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path(flags)
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    for label, tr in trainers.items():
        for i in range(TRAIN_STEPS[label]):
            tr.step(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tiers = path_launches(name, TRAIN_PATHS[name])
    log(f"  [{name}] {sum(TRAIN_STEPS[lb] for lb in trainers)} steps in {wall:.1f} s; "
        f"placement: {tiers}")
    entry = dict(launches=launches, placement=tiers, steps_wall_s=wall)
    for label, tr in trainers.items():
        losses = [float(v) for v in tr.losses]
        x = tr.batches[0]
        with torch.no_grad():        # after the counted window: this forward is inference
            after = float(tr.loss_fn(tr.params, x, x))
        require(all(np.isfinite(losses)) and after < losses[0],
                f"[{name}] {label}: the loss of batch 0 did not fall: {losses[0]} before the "
                f"steps, {after} after")
        log(f"  [{name}] {label}: loss per step {[round(v, 4) for v in losses]}; batch 0 "
            f"{losses[0]:.4f} before the steps, {after:.4f} after (fell by "
            f"{losses[0] - after:.4f})")
        entry[label] = dict(losses=losses, batch0_after=after, lr=TRAIN_LR,
                            tokens_per_step=tr.tokens)
    summary.setdefault("training", {})[name] = entry
    return launches


@contextlib.contextmanager
def norm_row_probe(torch, gen):
    """Inside: ZGML_TPU_KERNELS_FORCE unset, so every norm runs refs.rmsnorm
    under autograd, and each norm's output rows are scaled by (1 + SENS_EPS
    N(0, 1)) from `gen` (None: not scaled). That is the form K12's rounding
    takes: its output differs from plain only through each row's rsqrt (the
    sum of squares in another order; every later product in plain's order)."""
    from zgml_tpu_torch.ops import refs
    plain, forced = refs.rmsnorm, os.environ.pop("ZGML_TPU_KERNELS_FORCE", None)

    def scaled(x, gamma, eps=1e-5):
        out = plain(x, gamma, eps)
        if gen is None:
            return out
        return out * (1 + SENS_EPS * torch.randn((*out.shape[:-1], 1), device=out.device,
                                                 generator=gen))
    refs.rmsnorm = scaled
    try:
        yield
    finally:
        refs.rmsnorm = plain
        if forced is not None:
            os.environ["ZGML_TPU_KERNELS_FORCE"] = forced


@contextlib.contextmanager
def proj_out_probe(torch, gen):
    """Inside: each quantized projection's plain output (qmatmul_ref and
    the int8 tier's qmatmul_i8_ref, which the dispatch calls under
    force_ref()) scaled per element by (1 + SENS_EPS N(0, 1)) from `gen`
    (None: not scaled). That is the form K2's bf16 form's and K1's
    difference from plain takes: the same bf16 or int8 operands, exact
    products, f32 sums in another order; the next projection's int8 or bf16
    roundings, the cache's and the flash kernels' of those values then flip
    alike, where an embedding perturbation is mostly rounded away first."""
    from zgml_tpu_torch.ops import qmatmul as qmm
    plain, plain_i8 = qmm.qmatmul_ref, qmm.qmatmul_i8_ref

    def moved(out):
        if gen is None:
            return out
        return out * (1 + SENS_EPS * torch.randn(out.shape, device=out.device, generator=gen))
    qmm.qmatmul_ref = lambda x, w, bf16=False: moved(plain(x, w, bf16))
    qmm.qmatmul_i8_ref = lambda x, w: moved(plain_i8(x, w))
    try:
        yield
    finally:
        qmm.qmatmul_ref, qmm.qmatmul_i8_ref = plain, plain_i8


def grad_check(torch, tr, label, summary, norm_rows=False, proj_out=False):
    """One step's gradients of every trainable tensor with the kernels
    against the same step under force_ref(), per tensor within
    max(GRAD_RTOL * max|g|, SENS_MARGIN x how far the plain gradients move
    when tok_embd is scaled by (1 + SENS_EPS N(0, 1)) and, with norm_rows
    (a path whose norms are K12's), each norm's output rows as well
    (norm_row_probe), with proj_out (a path whose projections run K2's bf16
    form, whose sums' order its consumers' bf16 roundings turn into flips)
    each projection's output as well (proj_out_probe), measured from the
    same plain path unscaled)."""
    from zgml_tpu_torch.nn.train import value_and_grad
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.utils.tree import flatten, paths
    x = tr.batches[0]
    names = [n for n, _ in paths(tr.params)]

    def grads(params):
        return flatten(value_and_grad(tr.loss_fn, params, x, x)[1])[0]

    # at most two gradient sets of the model live at once (1.1 B f32 each at
    # TinyLlama-1.1B, beside the trainers' params and Adam state)
    gk = grads(tr.params)
    with force_ref():
        gr = grads(tr.params)
        errs = [(float((a - b).abs().max()), float(b.abs().max()), bool(torch.isfinite(a).all()))
                for a, b in zip(gk, gr)]
        del gk
        base, base_gap = gr, 0.0
        if norm_rows:
            with norm_row_probe(torch, None):
                base = grads(tr.params)
            base_gap = max(float((a - b).abs().max()) for a, b in zip(base, gr))
        del gr
        moves = [0.0] * len(base)
        gen = torch.Generator(device=x.device).manual_seed(SEED)
        emb = tr.params["tok_embd"]
        for _ in range(GRAD_SENS_DRAWS):
            p2 = {**tr.params, "tok_embd": emb * (1 + SENS_EPS * torch.randn(
                emb.shape, device=emb.device, generator=gen))}
            with (norm_row_probe(torch, gen) if norm_rows else contextlib.nullcontext()), \
                    (proj_out_probe(torch, gen) if proj_out else contextlib.nullcontext()):
                gp = grads(p2)
            moves = [max(m, float((a - b).abs().max())) for m, a, b in zip(moves, gp, base)]
            del gp, p2
        del base
    rows = [dict(tensor=name, err=err, scale=scale, plain_move=m,
                 bound=max(GRAD_RTOL * scale, SENS_MARGIN * m), finite=finite)
            for name, (err, scale, finite), m in zip(names, errs, moves)]
    bad = [r for r in rows if not (r["finite"] and r["err"] <= r["bound"])]
    worst = max(rows, key=lambda r: r["err"] / max(r["bound"], 1e-30))
    rel = max(r["err"] / max(r["scale"], 1e-30) for r in rows)
    log(f"  [{label}] one step's gradients vs force_ref(): {len(rows)} tensors, max "
        f"|dg|/max|g| {rel:.3g}; worst against its bound: {worst['tensor']} err "
        f"{worst['err']:.3g} bound {worst['bound']:.3g} (the plain path moves "
        f"{worst['plain_move'] / max(worst['scale'], 1e-30):.3g} of max|g| under {SENS_EPS:g} "
        f"perturbations of tok_embd" + (f" and every norm's rows; unscaled, its gradients are "
                                         f"{base_gap:.3g} from force_ref()'s" if norm_rows else "")
        + (" and every projection's output" if proj_out else "") + ")")
    require(not bad, f"[{label}] gradients off the plain path: {bad[:5]}")
    summary.setdefault("grad_check", {})[label] = dict(max_rel=rel, worst=worst, n=len(rows),
                                                       norm_rows=norm_rows, proj_out=proj_out,
                                                       tensors=rows)


def checkpoint_roundtrip(torch, tr, label, summary):
    """Save the params and Adam state in the ZGMT format and load them back
    bit for bit (io/checkpoint.py), under .bench_cache/ (deleted after)."""
    from zgml_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from zgml_tpu_torch.utils.tree import flatten
    path = ROOT / ".bench_cache" / f"{label}.zgmt"
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {"params": tr.params, "opt": tr.state}
    t0 = time.perf_counter()
    save_checkpoint(str(path), tree)
    size = path.stat().st_size
    try:
        back = load_checkpoint(str(path), tree)
    finally:
        path.unlink()
    leaves, got = flatten(tree)[0], flatten(back)[0]
    same = all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
               for a, b in zip(leaves, got))
    del back, got
    require(same and len(leaves) > 0, f"[{label}] checkpoint round trip is not bit-equal")
    log(f"  [{label}] checkpoint of params and Adam state: {len(leaves)} tensors, "
        f"{size / 1e9:.2f} GB written and read back bit-equal in {time.perf_counter() - t0:.1f} s")
    summary.setdefault("checkpoint", {})[label] = dict(tensors=len(leaves), bytes=size)


def train_rates(torch, trainers, card, summary):
    """ms per step and tokens/s of each training path, in turns (rounds of
    the paths there and back), the median per path."""
    order = list(trainers) + list(trainers)[::-1]
    runs = {name: [] for name in trainers}
    for _ in range(TRAIN_RATE_ROUNDS):
        for name in order:
            tr = trainers[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.step(0)
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
    for name, ts in runs.items():
        med = statistics.median(ts)
        tok = trainers[name].tokens
        log(f"  [{name}] {med * 1e3:.1f} ms per step ({tok} tokens), {tok / med:.1f} tokens/s; "
            f"fastest turn {min(ts) * 1e3:.1f} ms  [{card}]")
        summary.setdefault("train_rates", {})[name] = dict(
            step_ms=med * 1e3, tokens_per_s=tok / med, runs_s=ts, tokens=tok, order=order,
            rounds=TRAIN_RATE_ROUNDS, card=card)


def train_profile(torch, step, name, summary, key="train_profile", what="one step"):
    """Device time by kernel of one call of `step` (torch.profiler): a
    training step, or one graph_ffn value_and_grad."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    rows = []
    for _ in range(PROFILE_TRIES):     # see time_ms: a window may come back empty
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(ev.key, _self_device_us(ev), ev.count) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]
        if rows:
            break
    if not rows:
        summary.setdefault(key, {})[name] = dict(wall_us=wall * 1e6,
                                                 device_busy_us="not measured")
        log(f"  [{name}] {what}: host wall {wall * 1e3:.1f} ms, device busy not measured")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    summary.setdefault(key, {})[name] = dict(
        wall_us=wall * 1e6, device_busy_us=busy,
        kernels=[dict(name=k[:90], us=u, count=c) for k, u, c in rows[:15]])
    log(f"  [{name}] {what}: host wall {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / (wall * 1e6):.1f}%)")
    for k, u, c in rows[:10]:
        log(f"    {u / 1e3:8.3f} ms  x{c:<5} {k[:80]}")


def rates(torch, engines, prompt, long_prompt, card, summary):
    """pp128 and tg32 of every path, measured in turns: RATE_ROUNDS rounds of
    the paths there and back (default, unfused, ..., kv8_7b, kv8_7b, ...,
    unfused, default), one prefill and one 32-token decode_n per turn, so an
    order effect on the host falls on every path alike; the median per path.
    On LONG_RATE_PATHS each turn also times the LONG_PROMPT-token prefill
    (pp1536, where the prefill attention's split prefix shows end to end)
    and a 32-token decode_n after it (tg32 at that context)."""
    p128 = prompt[:128]
    runs = {name: ([], [], [], []) for name in engines}
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
            if name in LONG_RATE_PATHS:
                eng.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok = torch.argmax(eng.prefill(long_prompt), dim=-1)
                torch.cuda.synchronize()
                runs[name][3].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                eng.decode_n(tok, 32)
                torch.cuda.synchronize()
                runs[name][2].append(time.perf_counter() - t0)
    for name, (pp, tg, tg_long, pp_long) in runs.items():
        pp_s, tg_s = statistics.median(pp), statistics.median(tg)
        layers = engines[name].model.cfg.n_layers
        log(f"  [{name}] pp128: {128 / pp_s:.1f} tok/s ({pp_s * 1e3:.2f} ms per 128-token "
            f"chunk; fastest turn {128 / min(pp):.1f}; {layers} layers)  [{card}]")
        log(f"  [{name}] tg32:  {32 / tg_s:.1f} tok/s ({tg_s / 32 * 1e3:.3f} ms per token; "
            f"fastest turn {32 / min(tg):.1f})  [{card}]")
        summary.setdefault("rates", {})[name] = dict(
            pp128_tok_s=128 / pp_s, tg32_tok_s=32 / tg_s, pp128_runs_s=pp, tg32_runs_s=tg,
            order=order, rounds=RATE_ROUNDS, layers=layers, card=card)
        if tg_long:
            tl_s = statistics.median(tg_long)
            log(f"  [{name}] tg32 at a {LONG_PROMPT}-token context: {32 / tl_s:.1f} tok/s "
                f"({tl_s / 32 * 1e3:.3f} ms per token; fastest turn {32 / min(tg_long):.1f})  "
                f"[{card}]")
            pl_s = statistics.median(pp_long)
            log(f"  [{name}] pp{LONG_PROMPT}: {LONG_PROMPT / pl_s:.1f} tok/s ({pl_s * 1e3:.1f} ms "
                f"for the {LONG_PROMPT}-token prompt; fastest turn "
                f"{LONG_PROMPT / min(pp_long):.1f})  [{card}]")
            summary["rates"][name].update(tg32_long_tok_s=32 / tl_s, tg32_long_runs_s=tg_long,
                                          long_context=LONG_PROMPT,
                                          **{f"pp{LONG_PROMPT}_tok_s": LONG_PROMPT / pl_s,
                                             f"pp{LONG_PROMPT}_runs_s": pp_long})


def batch4_rates(torch, engines4, prompt4, card, summary):
    """tg32 of the batch-4 engines (BATCH4_PATHS: K8 in its f32-p mode on
    kv8_tiny, its I8PV mode on kv8_i8pv) in turns, RATE_ROUNDS rounds there
    and back: a 32-token decode_n of 4 rows after the prefill of `prompt4`
    (4 rows, untimed), on the host clock around synchronized calls; the
    median per path, in tokens/s of all 4 rows."""
    runs = {name: [] for name in engines4}
    order = list(engines4) + list(engines4)[::-1]
    for _ in range(RATE_ROUNDS):
        for name in order:
            set_path(name)
            eng = engines4[name]
            eng.reset()
            tok = torch.argmax(eng.prefill(prompt4), dim=-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.decode_n(tok, 32)
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
    for name, tg in runs.items():
        tg_s = statistics.median(tg)
        log(f"  [{name}] batch-4 tg32 after a {prompt4.shape[1]}-token prompt: "
            f"{4 * 32 / tg_s:.1f} tok/s ({tg_s / 32 * 1e3:.3f} ms per step of 4 tokens; "
            f"fastest turn {4 * 32 / min(tg):.1f})  [{card}]")
        summary["rates"][name].update(batch4_tg32_tok_s=4 * 32 / tg_s, batch4_tg32_runs_s=tg,
                                      batch4_prompt=prompt4.shape[1], batch4_order=order)


def profile(torch, eng, prompt, long_prompt, name, summary):
    """Device time by kernel of one 128-token prefill chunk and of 8 decode
    steps (torch.profiler over CUPTI), with K7's and K6's device time per
    token; on LONG_RATE_PATHS also of 8 decode steps after a
    LONG_PROMPT-token prefill (the layer kernel reads the cache prefix)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    out = {}
    labels = ("prefill128", "decode8") + (("decode8_long",) if name in LONG_RATE_PATHS else ())
    for label in labels:
        for _ in range(PROFILE_TRIES):     # see time_ms: a window may come back empty
            eng.reset()
            if label != "prefill128":
                ctx = long_prompt if label == "decode8_long" else prompt[:128]
                tok = torch.argmax(eng.prefill(ctx), dim=-1)
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
        if not rows:       # a breakdown only: the path's results were checked in phase 3
            out[label] = dict(wall_us=wall * 1e6, device_busy_us="not measured")
            log(f"  [{name}] {label}: host wall {wall * 1e3:.2f} ms, device busy not measured "
                f"(the profiler saw no kernel in {PROFILE_TRIES} windows)")
            continue
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        # K7 per token from its mean launch, as the window may lose records
        # (time_ms); busy is the sum of the records seen, a floor
        k7 = [(u, c) for k, u, c in rows if "layer_attn_kernel" in k]
        k7_seen = sum(c for _, c in k7)
        k7_us = sum(u for u, _ in k7) / k7_seen * eng.cfg.n_layers if k7_seen else 0.0
        # K6 (K6d / K6a / K6c) per token likewise; in a prefill chunk its
        # launches are the FFN calls of <= 32 rows, none at 128 rows
        k6 = [(u, c) for k, u, c in rows if "ffn_norm_kernel" in k]
        k6_seen = sum(c for _, c in k6)
        k6_us = sum(u for u, _ in k6) / k6_seen * eng.cfg.n_layers if k6_seen else 0.0
        # the megacall (K14 / K15), once per token
        mega = [(u, c) for k, u, c in rows if "stack_decode_kernel" in k]
        mega_seen = sum(c for _, c in mega)
        mega_us = sum(u for u, _ in mega) / mega_seen if mega_seen else 0.0
        per_token = sum(c for _, _, c in rows) / 8 if label != "prefill128" else None
        out[label] = dict(wall_us=wall * 1e6, device_busy_us=busy, k7_us_per_token=k7_us,
                          k7_launches_seen=k7_seen, k6_us_per_token=k6_us,
                          k6_launches_seen=k6_seen, megacall_us_per_token=mega_us,
                          megacall_launches_seen=mega_seen, kernels_per_token_seen=per_token,
                          kernels=[dict(name=k[:90], us=u, count=c) for k, u, c in rows[:15]])
        log(f"  [{name}] {label}: host wall {wall * 1e3:.2f} ms, device busy "
            f"{busy / 1e3:.2f} ms ({100 * busy / (wall * 1e6):.1f}%)"
            + (f"; {per_token:.1f} kernels per decode token seen" if per_token else "")
            + (f"; K7 {k7_us:.1f} us of device time per token ({k7_seen} of "
               f"{8 * eng.cfg.n_layers} launches seen)" if k7_seen else "")
            + (f"; K6 {k6_us:.1f} us of device time per token ({k6_seen} of "
               f"{8 * eng.cfg.n_layers} launches seen)" if k6_seen else "")
            + (f"; the megacall {mega_us:.1f} us per token ({mega_seen} of 8 launches seen)"
               if mega_seen else ""))
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
                **({"mode": MODE[name]} if name in MODE else {}),
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


def train_paths(torch, dev, models, summary, launches):
    """Phase 3's training paths: train_dense (TinyLlama-1.1B width at
    SHALLOW_LAYERS layers, dense f32 from init_params(seed 0), B 4 x T 512
    corpus windows) and
    train_q4_frozen (the TinyLlama Q4_0 GGUF with tok_embd and the norms
    trainable, B 1 x T 512, then the Q8_0 file the same way). Returns the
    trainers timed in phase 4: dense and the Q4_0 frozen one."""
    import dataclasses

    from zgml_tpu_torch.models.llama import init_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(preset("tinyllama-1.1b"), n_layers=SHALLOW_LAYERS)
    dense = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [dense["tok_embd"], dense["out_norm"], dense["lm_head"]]) \
        + sum(t.numel() for ly in dense["layers"] for t in ly.values())
    log(f"  init_params(TinyLlama-1.1B width, {cfg.n_layers} layers, seed {SEED}): "
        f"{n_params / 1e9:.3f} B f32 params in {time.perf_counter() - t0:.1f} s")
    trainers = {"train_dense": Trainer(llama_loss(cfg), dense,
                                       corpus_batches(torch, dev, TRAIN_B, TRAIN_T,
                                                      TRAIN_STEPS["train_dense"]))}
    launches["train_dense"] = train_path(torch, "train_dense", trainers, summary)
    grad_check(torch, trainers["train_dense"], "train_dense", summary)
    checkpoint_roundtrip(torch, trainers["train_dense"], "train_dense", summary)
    # rmsnorm_forced's training: the dense model's steps under
    # ZGML_TPU_KERNELS_FORCE=rmsnorm (K12 forward, its plain-recompute backward)
    # from the params train_dense reached, with a fresh Adam state
    name = "train_rmsnorm_forced"
    dense_tr = trainers["train_dense"]
    forced = {name: Trainer(llama_loss(cfg), dense_tr.params,
                            dense_tr.batches[:TRAIN_STEPS[name]])}
    launches[name] = train_path(torch, name, forced, summary, flags=name)
    want = TRAIN_STEPS[name] * (2 * cfg.n_layers + 1)
    require(launches[name]["rmsnorm"] == want,
            f"[{name}] K12 launched {launches[name]['rmsnorm']} times, want {want} "
            f"({2 * cfg.n_layers + 1} per forward)")
    forced[name].state = None        # its Adam moments (8.8 GB) are not needed again
    set_path(name)
    grad_check(torch, forced[name], name, summary, norm_rows=True)
    set_path("default")
    del forced
    frozen_tr = {}
    for kind, label in (("q4_0", "train_q4_frozen"), ("q8_0", "train_q8_frozen")):
        model = models["tinyllama-1.1b", kind]
        tr, merge = frozen(model)
        frozen_tr[label] = Trainer(llama_loss(model.cfg, merge), tr,
                                   corpus_batches(torch, dev, FROZEN_B, TRAIN_T,
                                                  TRAIN_STEPS[label]))
    launches["train_q4_frozen"] = train_path(torch, "train_q4_frozen", frozen_tr, summary)
    for label, tr in frozen_tr.items():      # their projections run K2's bf16 form
        grad_check(torch, tr, label, summary, proj_out=True)
    checkpoint_roundtrip(torch, frozen_tr["train_q4_frozen"], "train_q4_frozen", summary)
    # train_q4_short: the same frozen models on B 1 x T 32 windows (every
    # call of <= 32 rows: K1 projections, the fused FFN K6b / K6a's no-norm
    # form with its backward, K11, K10), the Q4_0 file then the Q8_0 one
    short_tr = {}
    for kind, label in (("q4_0", "train_q4_short"), ("q8_0", "train_q8_short")):
        model = models["tinyllama-1.1b", kind]
        tr, merge = frozen(model)
        short_tr[label] = Trainer(llama_loss(model.cfg, merge), tr,
                                  corpus_batches(torch, dev, FROZEN_B, SHORT_T,
                                                 TRAIN_STEPS[label]))
    launches["train_q4_short"] = train_path(torch, "train_q4_short", short_tr, summary)
    for label, tr in short_tr.items():        # K1's int8 activations, as K2's bf16 form
        grad_check(torch, tr, label, summary, proj_out=True)
    checkpoint_roundtrip(torch, short_tr["train_q4_short"], "train_q4_short", summary)
    return {"train_dense": trainers["train_dense"],
            "train_q4_frozen": frozen_tr["train_q4_frozen"],
            "train_q4_short": short_tr["train_q4_short"]}


def graph_ffn_graph():
    """The FFN of a TinyLlama-1.1B layer as a ComputeGraph loss:
    h = rmsnorm(x) * g; y = (silu(h @ w_gate) * (h @ w_up)) @ w_down + x;
    loss = mean(y^2)."""
    from zgml_tpu_torch.graph import var
    x, g = var("x", (GRAPH_ROWS, GRAPH_D)), var("g", (GRAPH_D,))
    wg, wu = var("w_gate", (GRAPH_D, GRAPH_F)), var("w_up", (GRAPH_D, GRAPH_F))
    wd = var("w_down", (GRAPH_F, GRAPH_D))
    h = x.rms_norm(g)
    y = h.matmul(wg).silu().mul(h.matmul(wu)).matmul(wd).add(x)
    return y.sqr().mean()


def graph_ffn_feeds(torch, dev) -> dict:
    """graph_ffn's vars, f32 from numpy's default_rng(SEED) at std GRAPH_STD
    (gamma 1 + GRAPH_STD N(0, 1)), on the card."""
    rng = np.random.default_rng(SEED)
    shapes = {"x": (GRAPH_ROWS, GRAPH_D), "g": (GRAPH_D,), "w_gate": (GRAPH_D, GRAPH_F),
              "w_up": (GRAPH_D, GRAPH_F), "w_down": (GRAPH_F, GRAPH_D)}
    out = {}
    for k, shape in shapes.items():
        v = (rng.standard_normal(shape) * GRAPH_STD).astype(np.float32)
        out[k] = torch.from_numpy(v + np.float32(1.0) if k == "g" else v).to(dev)
    return out


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def graph_ffn_path(torch, dev, summary):
    """ComputeGraph at TinyLlama-1.1B's FFN width: the fusion report has the
    chains silu -> mul and add -> sqr; one run and one value_and_grad with
    respect to gamma and the three weights launch K13 exactly twice each and
    nothing else; both agree with the same graph under force_ref() and with
    fuse=False; GRAPH_SGD_STEPS of SGD lower the loss. Returns (launches,
    the fused graph, its feeds) for phase 4."""
    from zgml_tpu_torch.graph import ComputeGraph
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.optim.sgd import sgd_update
    from zgml_tpu_torch.runtime.profile import global_profile
    name = "graph_ffn"
    set_path("default")
    loss = graph_ffn_graph()
    gf, gu = ComputeGraph(loss, device=dev), ComputeGraph(loss, fuse=False, device=dev)
    chains = [[n.op.value for n in c.nodes] for c in gf.fusion.chains]
    require(chains == GRAPH_CHAINS, f"[{name}] fusion report has chains {chains}, want "
            f"{GRAPH_CHAINS}:\n{gf.report()}")
    feeds = graph_ffn_feeds(torch, dev)
    vag = gf.value_and_grad(GRAPH_WRT)
    torch.cuda.synchronize()
    global_profile.reset()
    out = gf.run(**feeds)
    val, grads = vag(**feeds)
    torch.cuda.synchronize()
    launches, tiers = path_launches(name, ("fused_chain",))
    log(f"  [{name}] one run and one value_and_grad; placement: {tiers}")
    require(launches["fused_chain"] == 2 * len(GRAPH_CHAINS),
            f"[{name}] K13 launched {launches['fused_chain']} times, want "
            f"{2 * len(GRAPH_CHAINS)} (one per chain per forward)")
    with force_ref():
        out_r = gf.run(**feeds)
        val_r, grads_r = vag(**feeds)
    out_u = gu.run(**feeds)
    val_u, grads_u = gu.value_and_grad(GRAPH_WRT)(**feeds)
    torch.cuda.synchronize()
    errs = {"forward vs force_ref": _rel(out, out_r), "forward vs fuse=False": _rel(out, out_u),
            "value vs force_ref": _rel(val, val_r), "value vs fuse=False": _rel(val, val_u)}
    for k in GRAPH_WRT:
        errs[f"d{k} vs force_ref"] = _rel(grads[k], grads_r[k])
        errs[f"d{k} vs fuse=False"] = _rel(grads[k], grads_u[k])
    bad = {k: v for k, v in errs.items()
           if not v <= (GRAPH_GRAD_RTOL if k.startswith("d") else GRAPH_FWD_RTOL)}
    require(bool(torch.isfinite(out)) and all(bool(torch.isfinite(g).all())
                                              for g in grads.values()) and not bad,
            f"[{name}] off its references (|diff| / max|ref|): {bad}")
    log(f"  [{name}] loss {float(out):.6f}; |diff| / max|ref| (bounds {GRAPH_FWD_RTOL:g} forward, "
        f"{GRAPH_GRAD_RTOL:g} gradients): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    params = {k: feeds[k] for k in GRAPH_WRT}
    losses = []
    for _ in range(GRAPH_SGD_STEPS):
        val, grads = vag(**{**feeds, **params})
        losses.append(float(val))
        params = sgd_update(params, grads, GRAPH_LR)
    losses.append(float(gf.run(**{**feeds, **params})))
    require(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
            f"[{name}] {GRAPH_SGD_STEPS} SGD steps at lr {GRAPH_LR} did not lower the loss: "
            f"{losses}")
    log(f"  [{name}] {GRAPH_SGD_STEPS} SGD steps at lr {GRAPH_LR}: loss {losses}")
    summary.setdefault("graph", {})[name] = dict(
        chains=chains, report=gf.report(), launches=launches, placement=tiers, loss=float(out),
        rel_errs=errs, fwd_rtol=GRAPH_FWD_RTOL, grad_rtol=GRAPH_GRAD_RTOL, sgd_losses=losses,
        lr=GRAPH_LR)
    return launches, gf, feeds


def graph_sub_path(torch, dev, summary):
    """y.sub(x.exp()) and y.div(x.exp()) at [GRAPH_ROWS, GRAPH_D]: the chain
    value is the right operand of sub / div; on the card, through K13 (one
    launch per chain), they equal the same graph with fuse=False and numpy's
    y - exp(x), y / exp(x) (the JAX package's fused lowering computes
    exp(x) - y and exp(x) / y there; ROADMAP, Reference weak spots)."""
    from zgml_tpu_torch.graph import ComputeGraph, var
    from zgml_tpu_torch.runtime.profile import global_profile
    name = "graph_sub"
    set_path("default")
    x, y = var("x", (GRAPH_ROWS, GRAPH_D)), var("y", (GRAPH_ROWS, GRAPH_D))
    outs = [y.sub(x.exp()), y.div(x.exp())]
    gf, gu = ComputeGraph(outs, device=dev), ComputeGraph(outs, fuse=False, device=dev)
    chains = [[n.op.value for n in c.nodes] for c in gf.fusion.chains]
    require(chains == [["exp", "sub"], ["exp", "div"]], f"[{name}] chains {chains}")
    n = GRAPH_ROWS * GRAPH_D
    xn = np.linspace(-1, 1, n, dtype=np.float32).reshape(GRAPH_ROWS, GRAPH_D)
    yn = np.random.default_rng(SEED).uniform(1, 4, (GRAPH_ROWS, GRAPH_D)).astype(np.float32)
    torch.cuda.synchronize()
    global_profile.reset()
    got = gf.run(x=xn, y=yn)
    torch.cuda.synchronize()
    launches, tiers = path_launches(name, ("fused_chain",))
    require(launches["fused_chain"] == 2, f"[{name}] want 2 K13 launches: {tiers}")
    unfused = gu.run(x=xn, y=yn)
    want_np = (yn - np.exp(xn), yn / np.exp(xn))
    errs = {}
    for label, a, u, w in zip(("sub", "div"), got, unfused, want_np):
        w = torch.from_numpy(w).to(dev)
        errs[f"{label} vs fuse=False"] = _rel(a, u)
        errs[f"{label} vs numpy"] = _rel(a, w)
    require(all(v <= CHAIN_RTOL for v in errs.values()),
            f"[{name}] off fuse=False or numpy (|diff| / max|ref|, bound {CHAIN_RTOL:g}): {errs}")
    log(f"  [{name}] y - exp(x), y / exp(x) through K13: [0, 0] = {float(got[0][0, 0]):.4f}, "
        f"{float(got[1][0, 0]):.4f}; |diff| / max|ref|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    summary.setdefault("graph", {})[name] = dict(chains=chains, launches=launches,
                                                 rel_errs=errs, bound=CHAIN_RTOL)
    return launches


def graph_ffn_bf16_graph():
    """graph_ffn's FFN on r = GRAPH_RES_SCALE x + a, all vars bf16:
    h = rmsnorm(r) * g; y = (silu(h @ w_gate) * (h @ w_up)) @ w_down + r;
    loss = mean(y^2)."""
    from zgml_tpu_torch.graph import var
    x, a = var("x", (GRAPH_ROWS, GRAPH_D)), var("a", (GRAPH_ROWS, GRAPH_D))
    g = var("g", (GRAPH_D,))
    wg, wu = var("w_gate", (GRAPH_D, GRAPH_F)), var("w_up", (GRAPH_D, GRAPH_F))
    wd = var("w_down", (GRAPH_F, GRAPH_D))
    r = x.scale(GRAPH_RES_SCALE).add(a)
    h = r.rms_norm(g)
    y = h.matmul(wg).silu().mul(h.matmul(wu)).matmul(wd).add(r)
    return y.sqr().mean(), r


@contextlib.contextmanager
def chain_nudge(torch, sign):
    """Inside: every plain chain output (elementwise.fused_chain_ref, which
    force_ref() runs) moved by one ulp of its dtype towards sign * inf, a
    constant, so the gradient's function stays the plain one."""
    from zgml_tpu_torch.ops import elementwise
    plain = elementwise.fused_chain_ref

    def nudged(x, steps, sides):
        out = plain(x, steps, sides)
        with torch.no_grad():
            bits = {torch.bfloat16: 8, torch.float16: 11}.get(out.dtype, 24)
            _, e = torch.frexp(out.detach().float())
            step = sign * torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - bits)
        return (out.float() + step).to(out.dtype)
    elementwise.fused_chain_ref = nudged
    try:
        yield
    finally:
        elementwise.fused_chain_ref = plain


def graph_ffn_bf16_path(torch, dev, summary):
    """graph_ffn_bf16 (GRAPH_RES_SCALE above): the fusion report has
    GRAPH_BF16_CHAINS; one run and one value_and_grad with respect to gamma
    and the three weights launch K13's bf16 form once and its f32 form twice
    per forward and nothing else; the bf16 chain's output (r alone, the same
    feeds) within GRAPH_BF16_ULPS ulp per element of force_ref()'s; the loss
    and gradients within max(2 bf16 ulps of max|ref|, SENS_MARGIN x the plain
    graph's move under chain_nudge) of force_ref() and of fuse=False;
    GRAPH_SGD_STEPS of SGD (f32 master weights, bf16 in the graph) lower the
    loss. Returns (launches, the fused graph, its feeds) for phase 4."""
    from zgml_tpu_torch.graph import ComputeGraph
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.optim.sgd import sgd_update
    from zgml_tpu_torch.runtime.profile import global_profile
    name = "graph_ffn_bf16"
    set_path("default")
    loss, r = graph_ffn_bf16_graph()
    gf, gu = ComputeGraph(loss, device=dev), ComputeGraph(loss, fuse=False, device=dev)
    chains = [[n.op.value for n in c.nodes] for c in gf.fusion.chains]
    require(sorted(chains) == sorted(GRAPH_BF16_CHAINS),
            f"[{name}] fusion report has chains {chains}, want {GRAPH_BF16_CHAINS}:\n"
            f"{gf.report()}")
    feeds = {k: v.to(torch.bfloat16) for k, v in graph_ffn_feeds(torch, dev).items()}
    feeds["a"] = (torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (GRAPH_ROWS, GRAPH_D)).astype(np.float32) * GRAPH_STD)).to(dev, torch.bfloat16)
    vag = gf.value_and_grad(GRAPH_WRT)
    torch.cuda.synchronize()
    global_profile.reset()
    out = gf.run(**feeds)
    val, grads = vag(**feeds)
    torch.cuda.synchronize()
    launches, tiers = path_launches(name, ("fused_chain", "fused_chain_bf16"))
    log(f"  [{name}] one run and one value_and_grad; placement: {tiers}")
    require(launches["fused_chain_bf16"] == 2 and launches["fused_chain"] == 4,
            f"[{name}] K13 launched {launches['fused_chain_bf16']} times in bf16 and "
            f"{launches['fused_chain']} in f32, want 2 and 4 (per forward one bf16 chain, "
            f"two f32 ones)")
    rg = ComputeGraph(r, device=dev)
    r_feeds = {k: feeds[k] for k in ("x", "a")}
    r_got = rg.run(**r_feeds)
    with force_ref():
        r_want = rg.run(**r_feeds)
    r_ulps = chain_ulps(torch, r_got, r_want)
    require(r_got.dtype == torch.bfloat16 and r_ulps <= GRAPH_BF16_ULPS,
            f"[{name}] the bf16 chain's output is {r_ulps} ulps from force_ref()'s")
    with force_ref():
        out_r = gf.run(**feeds)
        val_r, grads_r = vag(**feeds)
        moves = {"loss": 0.0, **{k: 0.0 for k in GRAPH_WRT}}
        for sign in (1.0, -1.0):
            with chain_nudge(torch, sign):
                val_n, grads_n = vag(**feeds)
            moves["loss"] = max(moves["loss"], float((val_n - val_r).abs()))
            for k in GRAPH_WRT:
                moves[k] = max(moves[k], float((grads_n[k].float() - grads_r[k].float())
                                               .abs().max()))
    out_u = gu.run(**feeds)
    val_u, grads_u = gu.value_and_grad(GRAPH_WRT)(**feeds)
    torch.cuda.synchronize()

    def bound(ref, move):
        top = ref.float().abs().max()
        return max(float(2 * bf16_ulp(torch, top)), SENS_MARGIN * move)
    rows = {"loss vs force_ref": (val, val_r, moves["loss"]),
            "loss vs fuse=False": (val_u, val_r, moves["loss"]),
            "run vs force_ref": (out, out_r, moves["loss"])}
    for k in GRAPH_WRT:
        rows[f"d{k} vs force_ref"] = (grads[k], grads_r[k], moves[k])
        rows[f"d{k} vs fuse=False"] = (grads_u[k], grads_r[k], moves[k])
    errs = {k: (float((a.float() - b.float()).abs().max()), bound(b, m))
            for k, (a, b, m) in rows.items()}
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    require(bool(torch.isfinite(out)) and all(bool(torch.isfinite(g.float()).all())
                                              for g in grads.values()) and not bad,
            f"[{name}] off its references (max abs err, bound): {bad}")
    log(f"  [{name}] loss {float(out):.6f}; the bf16 chain {r_ulps:g} ulp from force_ref(); "
        f"(max abs err, bound): " + ", ".join(f"{k} {e:.3g} / {b:.3g}"
                                               for k, (e, b) in errs.items()))
    # mixed precision: f32 master weights, their bf16 copies in the graph (a
    # bf16 weight does not move under updates below half its ulp)
    master = {k: feeds[k].float() for k in GRAPH_WRT}
    losses = []
    for _ in range(GRAPH_SGD_STEPS):
        val, grads = vag(**{**feeds, **{k: v.to(torch.bfloat16) for k, v in master.items()}})
        losses.append(float(val))
        master = sgd_update(master, {k: v.float() for k, v in grads.items()}, GRAPH_LR)
    losses.append(float(gf.run(**{**feeds, **{k: v.to(torch.bfloat16)
                                              for k, v in master.items()}})))
    require(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
            f"[{name}] {GRAPH_SGD_STEPS} SGD steps at lr {GRAPH_LR} did not lower the loss: "
            f"{losses}")
    log(f"  [{name}] {GRAPH_SGD_STEPS} SGD steps at lr {GRAPH_LR} (f32 master weights, bf16 in "
        f"the graph): loss {losses}")
    summary.setdefault("graph", {})[name] = dict(
        chains=chains, report=gf.report(), launches=launches, placement=tiers, loss=float(out),
        chain_ulps=r_ulps, errs=errs, plain_moves=moves, sgd_losses=losses, lr=GRAPH_LR,
        res_scale=GRAPH_RES_SCALE)
    return launches, gf, feeds


def graph_rates(torch, gf, feeds, card, summary, name="graph_ffn"):
    """ms per run of graph `name` and per value_and_grad, in turns (run, vag,
    vag, run per round), GRAPH_RATE_ROUNDS rounds, the median of each."""
    vag = gf.value_and_grad(GRAPH_WRT)
    calls = {"run": lambda: gf.run(**feeds), "value_and_grad": lambda: vag(**feeds)}
    runs = {k: [] for k in calls}
    for _ in range(GRAPH_RATE_ROUNDS):
        for k in ("run", "value_and_grad", "value_and_grad", "run"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[k]()
            torch.cuda.synchronize()
            runs[k].append(time.perf_counter() - t0)
    out = {}
    for k, ts in runs.items():
        med = statistics.median(ts)
        out[k] = dict(ms=med * 1e3, runs_s=ts)
        log(f"  [{name}] {k}: {med * 1e3:.2f} ms (median of {len(ts)}; fastest "
            f"{min(ts) * 1e3:.2f})  [{card}]")
    summary.setdefault("graph_rates", {})[name] = dict(out, card=card,
                                                       rounds=GRAPH_RATE_ROUNDS)
    train_profile(torch, lambda: vag(**feeds), name, summary, key="graph_profile",
                  what="one value_and_grad")


def bpe_tokenizer():
    from zgml_tpu_torch.io.tokenizer import BPETokenizer
    bpe = ROOT / "tests" / "data" / "bpe"
    return BPETokenizer.from_files(bpe / "vocab.json", bpe / "merges.txt")


def mixed_kinds(n_layers: int) -> dict:
    """mixed_tiny's tensor types inside its Q4_0 file (the comment above MIXED_TEXT)."""
    from zgml_tpu_torch.io.gguf import GGMLType
    kinds = {"output.weight": GGMLType.Q8_0}
    for i in range(n_layers):
        if i % 2 == 0:
            kinds[f"blk.{i}.attn_v.weight"] = GGMLType.Q8_0
        if i % 4 == 1:
            kinds[f"blk.{i}.ffn_up.weight"] = GGMLType.Q8_0
        if i % 4 == 3:
            kinds[f"blk.{i}.ffn_down.weight"] = GGMLType.Q8_0
    return kinds


def mixed_model_path() -> pathlib.Path:
    from zgml_tpu_torch.io.gguf import GGMLType
    from zgml_tpu_torch.utils.synthetic import write_synthetic_llama_gguf
    cfg = preset("tinyllama-1.1b")
    path = ROOT / ".bench_cache" / f"tinyllama-1.1b-mixed-q4_0-seed{SEED}-std{WEIGHT_STD}.gguf"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_synthetic_llama_gguf(str(path), cfg, quant=GGMLType.Q4_0, seed=SEED,
                                   scale=WEIGHT_STD, kinds=mixed_kinds(cfg.n_layers),
                                   tokenizer=bpe_tokenizer())
        log(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        log(f"  reusing {path.name}")
    return path


def run_cli(argv) -> list[str]:
    """zgml_tpu_torch's command line in this process; its printed lines."""
    import io

    from zgml_tpu_torch.utils import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().splitlines()


def cli_ids(lines, label) -> list[int]:
    line = next(ln for ln in lines if ln.startswith(label))
    return json.loads(line[len(label):].strip())


def mixed_paths(torch, dev, summary):
    """mixed_tiny / mixed_kv8_tiny: the mixed-kind TinyLlama-1.1B GGUF
    (mixed_kinds, the repo's BPE inside) through the command line a user
    calls: `inspect`, then `generate --prompt MIXED_TEXT -n 32` on the card
    over the bf16 and the int8 cache, the placement counts set to 0 just
    before each and read just after, holding the routes JAX takes (over the
    bf16 cache `_layer_step` in every layer: K4 22 times a decode token, no
    K7; over the int8 cache K7 on the 11 layers with a fused Q4_0 wqkv and
    K8 at batch 1 on the other 11), K1q8 on wv, ffn_up and ffn_down, K5q8
    for the head, K6b only in the layers whose gate|up and down are both
    Q4_0. Then each request against the plain versions (against_plain) on
    the same model and engine. Returns {path: launches}."""
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path("default")
    path = mixed_model_path()
    lines = run_cli(["inspect", str(path)])
    for ln in lines:
        log(f"  [mixed_tiny] inspect: {ln}")
    model, gf = load_llama(str(path), device=dev)
    gf.close()
    n = model.cfg.n_layers
    n_q8 = len(mixed_kinds(n))
    census = sorted(ln.strip() for ln in lines if ln.endswith(" tensors") and ":" in ln)
    want = sorted(f"{t}: {c} tensors" for t, c in (("Q4_0", 7 * n + 1 - n_q8), ("Q8_0", n_q8),
                                                    ("F32", 2 * n + 2)))
    require(census == want, f"[mixed_tiny] inspect's census {census}, want {want}")
    fused = sum("wqkv" in ly for ly in model.params["layers"])
    require(fused == n // 2 and all(ly["wqkv"].kind == "q4_0" for ly in model.params["layers"]
                                    if "wqkv" in ly)
            and model.params["lm_head"].kind == "q8_0",
            f"[mixed_tiny] the layout is not the mix's: "
            f"{[sorted(ly) for ly in model.params['layers'][:4]]}")
    out = {}
    for name, (cache, kernels) in MIXED_PATHS.items():
        torch.cuda.synchronize()
        global_profile.reset()
        t0 = time.perf_counter()
        lines = run_cli(["generate", str(path), "--prompt", MIXED_TEXT, "-n", "32"]
                        + (["--kv", "int8"] if cache == "int8" else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # K4 in every layer over the bf16 cache; over the int8 cache K7 where
        # wqkv is fused and K8 in the others
        per_token = ({"decode_attention": n} if cache == "bf16" else
                     {"attn_block_kv8": fused, "decode_attention_q8": n - fused})
        launches, tiers = path_launches(name, kernels, per_token)
        prompt, toks = cli_ids(lines, "prompt ids:"), cli_ids(lines, "output ids:")
        require(len(toks) == 32 and all(0 <= t < model.cfg.vocab_size for t in toks),
                f"[{name}] output {toks}")
        log(f"  [{name}] `generate --prompt {MIXED_TEXT!r}{' --kv int8' if cache == 'int8' else ''}` "
            f"in {wall:.1f} s (load included): prompt ids {prompt} -> {toks}; placement: {tiers}")
        eng = LlamaEngine(model, prefill_chunk=128, cache_dtype=cache)
        entry = dict(cache=cache, prompt_ids=prompt, outputs=toks, launches=launches,
                     placement=tiers, wall_s=wall,
                     **against_plain(torch, eng, np.asarray(prompt), toks, name, "the prompt"))
        summary.setdefault("e2e", {})[name] = entry
        out[name] = launches
        del eng
    del model
    torch.cuda.empty_cache()
    return out


def eval_tokens() -> np.ndarray:
    ids = np.load(ROOT / "tests" / "data" / "corpus_tokens.npy").astype(np.int64)
    return ids[:EVAL_WINDOWS * EVAL_WINDOW + 1]


def eval_check(torch, model, toks, cache, label, quantized, ppl):
    """The card's ppl of `model` on `toks` (`ppl`) against the same model's under
    force_ref() on the card, within max(EVAL_RTOL[quantized] * ppl, SENS_MARGIN x the
    plain path's own move when the embedding rows of the tokens (and, on a
    quantized model, every projection's plain output: proj_out_probe) are
    scaled by 1 + SENS_EPS N(0, 1), EVAL_SENS_DRAWS draws)."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.eval import perplexity
    embd = model.params["tok_embd"]
    ids = sorted({int(i) for i in toks})
    rows = embd[ids].clone()
    g = torch.Generator(device=rows.device).manual_seed(SEED)
    with force_ref():
        ref = perplexity(model, toks, EVAL_WINDOW, cache)
        moves = []
        for _ in range(EVAL_SENS_DRAWS):
            embd[ids] = rows * (1 + SENS_EPS * torch.randn(rows.shape, device=rows.device,
                                                           generator=g))
            with proj_out_probe(torch, g) if quantized else contextlib.nullcontext():
                moves.append(abs(perplexity(model, toks, EVAL_WINDOW, cache) - ref))
        embd[ids] = rows
    bound = max(EVAL_RTOL[quantized] * ref, SENS_MARGIN * max(moves))
    err = abs(ppl - ref)
    require(math.isfinite(ppl) and err <= bound,
            f"[{label}] ppl {ppl!r} against force_ref()'s {ref!r}: {err:.4g} > bound {bound:.4g} "
            f"(the plain path moves {[f'{m:.3g}' for m in moves]})")
    log(f"  [{label}] ppl {ppl:.6f} (force_ref() {ref:.6f}, {err / ref:.3g} relative; bound "
        f"{bound / ref:.3g}, the plain path moves {max(moves) / ref:.3g} under {SENS_EPS:g} "
        f"perturbations)")
    return dict(ppl=ppl, ppl_plain=ref, err=err, bound=bound, sensitivity=moves)


def window_time(torch, model, toks, cache):
    """Host wall and device busy (torch.profiler, the kernel records) of one
    window_nll of EVAL_WINDOW + 1 tokens, after one untimed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from zgml_tpu_torch.runtime.eval import window_nll
    chunk = toks[:EVAL_WINDOW + 1]
    window_nll(model, chunk, cache)
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window_nll(model, chunk, cache)        # returns a float: synchronized
            wall = time.perf_counter() - t0
        busy = sum(_self_device_us(ev) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
        if busy:
            return wall * 1e3, busy / 1e3
    return wall * 1e3, "not measured"


def eval_path(torch, dev, models, summary):
    """eval_tiny: perplexity (runtime/eval.py) of the first EVAL_WINDOWS
    windows of EVAL_WINDOW tokens of tests/data/corpus_tokens.npy on the
    TinyLlama-1.1B Q4_0 and Q8_0 files, each loaded dense (load_llama
    mode="dense": torch.matmul projections, K3) and quantized (K2's bf16
    form, K3), the Q4_0 one also over the int8 cache (K9), the placement
    counts set to 0 just before the card's runs and read just after; each
    ppl held to force_ref()'s (eval_check); ppl, dppl per pair, and the wall
    and device time of one window. Returns the launches."""
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.runtime.eval import perplexity
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path("default")
    toks = eval_tokens()
    log(f"  [eval_tiny] {EVAL_WINDOWS} windows of {EVAL_WINDOW} tokens of the corpus "
        f"({len(toks)} ids)")
    runs = []          # (label, model, cache, quantized)
    dense = {}
    for kind in KINDS:
        t0 = time.perf_counter()
        model, gf = load_llama(str(model_path("tinyllama-1.1b", kind)), device=dev, mode="dense")
        gf.close()
        torch.cuda.synchronize()
        log(f"  [eval_tiny] loaded the {kind} file dense in {time.perf_counter() - t0:.1f} s")
        dense[kind] = model
        runs += [(f"{kind} dense", model, "bf16", False),
                 (f"{kind}", models["tinyllama-1.1b", kind], "bf16", True)]
    runs.append(("q4_0 int8 cache", models["tinyllama-1.1b", "q4_0"], "int8", True))
    torch.cuda.synchronize()
    global_profile.reset()
    ppl = {label: perplexity(m, toks, EVAL_WINDOW, cache) for label, m, cache, _ in runs}
    torch.cuda.synchronize()
    launches, tiers = path_launches("eval_tiny", EVAL_KERNELS)
    windows = global_profile.phase_calls["eval_window"]
    require(windows == EVAL_WINDOWS * len(runs), f"[eval_tiny] {windows} windows")
    card = card_line()
    entry = dict(windows=EVAL_WINDOWS, window=EVAL_WINDOW, launches=launches, placement=tiers,
                 runs={})
    for label, m, cache, quantized in runs:
        check = eval_check(torch, m, toks, cache, f"eval_tiny {label}", quantized, ppl[label])
        wall_ms, device_ms = window_time(torch, m, toks, cache)
        check.update(window_wall_ms=wall_ms, window_device_ms=device_ms)
        entry["runs"][label] = check
        log(f"  [eval_tiny {label}] one window of {EVAL_WINDOW + 1} tokens: host wall "
            f"{wall_ms:.2f} ms, device busy "
            + (f"{device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f}%)"
               if isinstance(device_ms, float) else device_ms) + f"  ({card})")
    for a, b in (("q4_0 dense", "q4_0"), ("q8_0 dense", "q8_0"), ("q4_0", "q4_0 int8 cache")):
        d = ppl[b] - ppl[a]
        entry.setdefault("deltas", {})[f"{b} vs {a}"] = d
        log(f"  [eval_tiny] {b} vs {a}: ppl {ppl[b]:.6f} vs {ppl[a]:.6f}, dppl {d:+.6f} "
            f"({d / ppl[a]:+.3g} relative)  ({card})")
    summary["eval_tiny"] = entry
    del dense, runs
    torch.cuda.empty_cache()
    return launches


def write_f16_checkpoint(torch, dev, path: pathlib.Path, spec: dict, config=None):
    """Write `spec` {HF name: a shape, drawn at WEIGHT_STD on the card from
    SEED, or a numpy array, written as it is} to `path` as F16 safetensors
    (with `config` as config.json beside it), once."""
    from zgml_tpu_torch.io.safetensors import save_safetensors
    if path.exists():
        log(f"  reusing {path}")
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    tensors = {}
    for name, v in spec.items():
        if isinstance(v, np.ndarray):
            tensors[name] = v.astype(np.float16)
        else:
            w = torch.randn(v, generator=g, device=dev, dtype=torch.float32) * WEIGHT_STD
            tensors[name] = w.to(torch.float16).cpu().numpy()
    if config is not None:
        (path.parent / "config.json").write_text(json.dumps(config))
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    save_safetensors(tmp, tensors)
    os.replace(tmp, path)
    log(f"  wrote {path.name} ({path.stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")


def hf_model_path(torch, dev, cfg) -> pathlib.Path:
    """A TinyLlama-1.1B-shaped HF llama checkpoint in F16 (HF names, [out,
    in] weights, norms 1), drawn at WEIGHT_STD on the card from SEED (torch's
    generator there: numpy's draws of 1.1B values took ~25 s of a 32 s
    write), written once (write_f16_checkpoint)."""
    path = ROOT / ".bench_cache" / f"tinyllama-1.1b-hf-f16-seed{SEED}-std{WEIGHT_STD}.safetensors"
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    ones = np.ones(d, np.float32)
    spec = {"model.embed_tokens.weight": (cfg.vocab_size, d), "model.norm.weight": ones}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        spec.update({p + "input_layernorm.weight": ones,
                     p + "post_attention_layernorm.weight": ones,
                     p + "self_attn.q_proj.weight": (cfg.n_heads * hd, d),
                     p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, d),
                     p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, d),
                     p + "self_attn.o_proj.weight": (d, cfg.n_heads * hd),
                     p + "mlp.gate_proj.weight": (f, d),
                     p + "mlp.up_proj.weight": (f, d),
                     p + "mlp.down_proj.weight": (d, f)})
    spec["lm_head.weight"] = (cfg.vocab_size, d)
    write_f16_checkpoint(torch, dev, path, spec)
    return path


def hf_path(torch, dev, prompt, summary):
    """hf_tiny: the HF checkpoint (hf_model_path) through load_llama_hf onto
    the card (dense f32), then LlamaModel.quantize("q8_0") and, from the same
    dense weights (quantize leaves them as they are), quantize("q4_0"), each
    timed; packed.quantize's planes against the numpy codec's for one weight
    of each kind; the ppl of each on eval_tiny's windows and its dppl
    against the dense model (the FP16-vs-quantized measure); a greedy
    request of 32 tokens on each quantized model against the plain versions
    (against_plain). The placement counts are set to 0 before the card's
    runs and read after. Returns the launches."""
    from zgml_tpu_torch.io.hf_loaders import load_llama_hf
    from zgml_tpu_torch.models.llama import LlamaModel
    from zgml_tpu_torch.quant import blocks, packed
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.eval import perplexity
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path("default")
    cfg = preset("tinyllama-1.1b")
    path = hf_model_path(torch, dev, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = load_llama_hf(str(path), cfg, device=dev)
    torch.cuda.synchronize()
    times = dict(load_s=time.perf_counter() - t0)
    quant = {}
    for kind in KINDS:
        t0 = time.perf_counter()
        quant[kind] = LlamaModel(cfg, dense.params).quantize(kind)
        torch.cuda.synchronize()
        times[f"quantize_{kind}_s"] = time.perf_counter() - t0
    require(not any(isinstance(v, packed.PackedWeight) for v in dense.params["layers"][0].values()),
            "[hf_tiny] quantize changed the dense weights")
    # the device quantizer against the numpy GGUF codecs on one weight each
    w = dense.params["layers"][0]["wo"].t().contiguous()
    host = w.cpu().numpy()
    for kind, (codec, split) in (("q8_0", (blocks.quantize_q8_0, packed.from_gguf_q8_0)),
                                 ("q4_0", (blocks.quantize_q4_0, packed.from_gguf_q4_0))):
        want = split(codec(host), *host.shape, device="cpu")
        got = packed.quantize(w, kind)
        require(torch.equal(got.qs.cpu(), want.qs)
                and torch.equal(got.d.cpu().view(torch.int16), want.d.view(torch.int16)),
                f"[hf_tiny] packed.quantize({kind}) differs from the numpy codec")
    log(f"  [hf_tiny] load_llama_hf {times['load_s']:.2f} s, quantize q8_0 "
        f"{times['quantize_q8_0_s']:.3f} s, q4_0 {times['quantize_q4_0_s']:.3f} s (on the card); "
        f"packed.quantize equals the numpy codec at both kinds  ({card_line()})")
    toks = eval_tokens()
    torch.cuda.synchronize()
    global_profile.reset()
    ppl = {"dense": perplexity(dense, toks, EVAL_WINDOW)}
    outs = {}
    for kind, model in quant.items():
        ppl[kind] = perplexity(model, toks, EVAL_WINDOW)
        eng = LlamaEngine(model, prefill_chunk=128)
        outs[kind] = eng.generate(prompt, 32)
    torch.cuda.synchronize()
    launches, tiers = path_launches("hf_tiny", HF_KERNELS)
    entry = dict(times=times, ppl=ppl, outputs=outs, launches=launches, placement=tiers)
    for kind in KINDS:
        d = ppl[kind] - ppl["dense"]
        entry.setdefault("deltas", {})[kind] = d
        log(f"  [hf_tiny] {kind} vs the F16 checkpoint dense: ppl {ppl[kind]:.6f} vs "
            f"{ppl['dense']:.6f}, dppl {d:+.6f} ({d / ppl['dense']:+.3g} relative)")
        log(f"  [hf_tiny {kind}] greedy prompt {len(prompt)} tokens -> {outs[kind]}")
        eng = LlamaEngine(quant[kind], prefill_chunk=128)
        entry[f"plain_{kind}"] = against_plain(torch, eng, prompt, outs[kind], "hf_tiny",
                                               f"{kind} greedy request")
        del eng
    summary["hf_tiny"] = entry
    del dense, quant
    torch.cuda.empty_cache()
    return launches


def weight_form_paths(torch, dev, models, prompt, summary):
    """Phase 3's weight forms and quality tools: mixed_tiny, eval_tiny,
    hf_tiny. Returns {path: launches}."""
    t0 = time.perf_counter()
    out = mixed_paths(torch, dev, summary)
    t1 = time.perf_counter()
    out["eval_tiny"] = eval_path(torch, dev, models, summary)
    t2 = time.perf_counter()
    out["hf_tiny"] = hf_path(torch, dev, prompt, summary)
    summary["weight_forms_s"] = dict(mixed_tiny=t1 - t0, eval_tiny=t2 - t1,
                                     hf_tiny=time.perf_counter() - t2)
    log(f"  mixed_tiny {t1 - t0:.1f} s, eval_tiny {t2 - t1:.1f} s, hf_tiny "
        f"{time.perf_counter() - t2:.1f} s (file writes included)")
    return out


def gpt2_spec(cfg) -> dict:
    """GPT-2's HF tensors (wte, wpe, h.{i}.ln_1 / attn.c_attn / attn.c_proj /
    ln_2 / mlp.c_fc / mlp.c_proj, ln_f; Conv1D weights [in, out]): LayerNorm
    gains 1 and biases 0, every other tensor drawn."""
    d, f = cfg.d_model, cfg.ff
    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
    spec = {"wte.weight": (cfg.vocab_size, d), "wpe.weight": (cfg.max_seq_len, d),
            "ln_f.weight": ones, "ln_f.bias": zeros}
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        spec.update({p + "ln_1.weight": ones, p + "ln_1.bias": zeros,
                     p + "attn.c_attn.weight": (d, 3 * d), p + "attn.c_attn.bias": (3 * d,),
                     p + "attn.c_proj.weight": (d, d), p + "attn.c_proj.bias": (d,),
                     p + "ln_2.weight": ones, p + "ln_2.bias": zeros,
                     p + "mlp.c_fc.weight": (d, f), p + "mlp.c_fc.bias": (f,),
                     p + "mlp.c_proj.weight": (f, d), p + "mlp.c_proj.bias": (d,)})
    return spec


def whisper_spec(cfg) -> dict:
    """Whisper's HF tensors (model.encoder.conv1 / conv2 [out, in, 3],
    embed_positions, layers.{i}.self_attn.{q,k,v,out}_proj (k without a
    bias), fc1, fc2 and their norms, layer_norm; the decoder's embed_tokens,
    embed_positions, layers with encoder_attn, layer_norm): LayerNorm gains 1
    and biases 0, the encoder positions the sinusoidal table (as HF's
    checkpoints hold it), every other tensor drawn."""
    from zgml_tpu_torch.models.gpt import sinusoidal_positions
    d = cfg.n_audio_state
    ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)

    def norm(name):
        return {name + ".weight": ones, name + ".bias": zeros}

    def attn(name):
        return {name + ".q_proj.weight": (d, d), name + ".q_proj.bias": (d,),
                name + ".k_proj.weight": (d, d), name + ".v_proj.weight": (d, d),
                name + ".v_proj.bias": (d,), name + ".out_proj.weight": (d, d),
                name + ".out_proj.bias": (d,)}

    def block(name, cross):
        out = {**attn(name + ".self_attn"), **norm(name + ".self_attn_layer_norm"),
               name + ".fc1.weight": (4 * d, d), name + ".fc1.bias": (4 * d,),
               name + ".fc2.weight": (d, 4 * d), name + ".fc2.bias": (d,),
               **norm(name + ".final_layer_norm")}
        if cross:
            out.update({**attn(name + ".encoder_attn"), **norm(name + ".encoder_attn_layer_norm")})
        return out
    e, dec = "model.encoder.", "model.decoder."
    spec = {e + "conv1.weight": (d, cfg.n_mels, 3), e + "conv1.bias": (d,),
            e + "conv2.weight": (d, d, 3), e + "conv2.bias": (d,),
            e + "embed_positions.weight": sinusoidal_positions(cfg.n_audio_ctx, d),
            **norm(e + "layer_norm"),
            dec + "embed_tokens.weight": (cfg.vocab_size, d),
            dec + "embed_positions.weight": (cfg.n_text_ctx, d), **norm(dec + "layer_norm")}
    for i in range(cfg.n_audio_layers):
        spec.update(block(f"{e}layers.{i}", False))
    for i in range(cfg.n_text_layers):
        spec.update(block(f"{dec}layers.{i}", True))
    return spec


def device_busy(torch, run) -> tuple[float, float | str]:
    """(host wall us, device busy us) of one call of `run` under
    torch.profiler (the kernels' records, a floor: records get lost), or
    "not measured" where PROFILE_TRIES windows saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(_self_device_us(ev) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
        if busy:
            return wall * 1e6, busy
    return wall * 1e6, "not measured"


def busy_text(wall_us, busy_us) -> str:
    if isinstance(busy_us, str):
        return f"host wall {wall_us / 1e3:.2f} ms, device busy {busy_us}"
    return (f"host wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
            f"({100 * busy_us / wall_us:.1f}%)")


def gpt2_path(torch, dev, card, summary):
    """gpt2_xl: GPT-2 XL at full width and depth from an F16 HF checkpoint
    (gpt2_spec, written once to .bench_cache/) through load_gpt2_hf, served by
    LlamaEngine: a GPT_PROMPT-token prompt (one chunk: K3's bf16 form in every
    layer) and GPT_NEW greedy tokens (K4 in every layer a decode token); the
    placement counts (no plain version, K4 exactly n_layers a decode token),
    the request against force_ref() (against_plain), pp128 and tg32 (host
    clock, RATE_ROUNDS runs, median) and the device-busy share of a chunk and
    8 decode steps (profile). Returns the launches."""
    from zgml_tpu_torch.io.hf_loaders import load_gpt2_hf
    from zgml_tpu_torch.models.gpt import GPTConfig
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path("default")
    cfg = GPTConfig(**GPT2_XL)
    path = ROOT / ".bench_cache" / f"gpt2-xl-hf-f16-seed{SEED}-std{WEIGHT_STD}.safetensors"
    write_f16_checkpoint(torch, dev, path, gpt2_spec(cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_gpt2_hf(str(path), cfg, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    def numel(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        return sum(numel(v) for v in (tree.values() if isinstance(tree, dict) else tree))
    n_params = numel(model.params)
    log(f"  [gpt2_xl] load_gpt2_hf {load_s:.2f} s: {n_params / 1e9:.3f} B f32 params on the card, "
        f"{cfg}")
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, GPT_PROMPT)
    eng = LlamaEngine(model, prefill_chunk=128)
    torch.cuda.synchronize()
    global_profile.reset()
    out = eng.generate(prompt, GPT_NEW)
    torch.cuda.synchronize()
    launches, tiers = path_launches("gpt2_xl", GPT_KERNELS, {"decode_attention": cfg.n_layers})
    require(len(out) == GPT_NEW and all(0 <= t < cfg.vocab_size for t in out),
            f"[gpt2_xl] greedy request gave {out}")
    log(f"  [gpt2_xl] placement: {tiers}")
    log(f"  [gpt2_xl] prompt {GPT_PROMPT} tokens, greedy -> {out}")
    entry = dict(config=GPT2_XL, load_s=load_s, n_params=n_params, launches=launches,
                 placement=tiers, outputs=out,
                 **against_plain(torch, eng, prompt, out, "gpt2_xl", "request 1"))
    f32_launches, f32_entry, f32_eng = gpt2_f32_path(torch, model, prompt, summary)
    # pp128 / tg32 of gpt2_xl and gpt2_xl_f32 in turns
    runs = {"gpt2_xl": (eng, [], []), "gpt2_xl_f32": (f32_eng, [], [])}
    for _ in range(RATE_ROUNDS):
        for name_, (e, pp, tg) in runs.items():
            e.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = torch.argmax(e.prefill(prompt), dim=-1)
            torch.cuda.synchronize()
            pp.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            e.decode_n(tok, 32)
            torch.cuda.synchronize()
            tg.append(time.perf_counter() - t0)
    for (name_, (e, pp, tg)), ent in zip(runs.items(), (entry, f32_entry)):
        ent["rates"] = dict(pp128_tok_s=GPT_PROMPT / statistics.median(pp),
                            tg32_tok_s=32 / statistics.median(tg), pp128_runs_s=pp,
                            tg32_runs_s=tg, layers=e.model.cfg.n_layers, card=card)
        log(f"  [{name_}] pp128: {ent['rates']['pp128_tok_s']:.1f} tok/s, tg32: "
            f"{ent['rates']['tg32_tok_s']:.1f} tok/s (medians of {RATE_ROUNDS}, in turns; "
            f"{e.model.cfg.n_layers} layers)  [{card}]")
    profile(torch, eng, prompt, prompt, "gpt2_xl", summary)
    summary["gpt2_xl"] = entry
    summary["gpt2_xl_f32"] = f32_entry
    del eng, model, f32_eng
    torch.cuda.empty_cache()
    return launches, f32_launches


def gpt2_f32_path(torch, model, prompt, summary):
    """gpt2_xl_f32: GPT-2 XL's first SHALLOW_LAYERS layers (the loaded
    model's tensors, full width) over an f32 cache: the GPT_PROMPT-token
    prompt (K3's f32-K/V bf16 form in every layer) and GPT_NEW greedy tokens
    (K4's f32 form in every layer a decode token), the placement counts and
    the request against force_ref(). Returns (launches, entry, engine)."""
    import dataclasses

    from zgml_tpu_torch.models.gpt import GPTModel
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    cfg = dataclasses.replace(model.cfg, n_layers=SHALLOW_LAYERS)
    shallow = GPTModel(cfg, {**model.params, "layers": model.params["layers"][:SHALLOW_LAYERS]})
    eng = LlamaEngine(shallow, prefill_chunk=128, cache_dtype="f32")
    require(eng.cache["k"].dtype == torch.float32, "[gpt2_xl_f32] the cache is not f32")
    torch.cuda.synchronize()
    global_profile.reset()
    out = eng.generate(prompt, GPT_NEW)
    torch.cuda.synchronize()
    launches, tiers = path_launches("gpt2_xl_f32", GPT_F32_KERNELS,
                                    {"decode_attention_f32": cfg.n_layers})
    require(len(out) == GPT_NEW and all(0 <= t < cfg.vocab_size for t in out),
            f"[gpt2_xl_f32] greedy request gave {out}")
    log(f"  [gpt2_xl_f32] {cfg.n_layers} layers over an f32 cache: placement: {tiers}")
    log(f"  [gpt2_xl_f32] prompt {GPT_PROMPT} tokens, greedy -> {out}")
    entry = dict(layers=cfg.n_layers, cache="f32", launches=launches, placement=tiers,
                 outputs=out, **against_plain(torch, eng, prompt, out, "gpt2_xl_f32",
                                              "request 1"))
    return launches, entry, eng


def whisper_wave() -> np.ndarray:
    """WHISPER_SECONDS of audio at 16 kHz from SEED: WHISPER_TONES, each at a
    random amplitude and phase, plus white noise."""
    from zgml_tpu_torch.data.audio import SAMPLE_RATE
    rng = np.random.default_rng(SEED)
    t = np.arange(WHISPER_SECONDS * SAMPLE_RATE) / SAMPLE_RATE
    wave = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
               for f in WHISPER_TONES)
    return (wave + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def whisper_path(torch, dev, card, summary):
    """whisper_large_v3: Whisper large-v3's shapes from an F16 HF checkpoint
    with its config.json (whisper_spec, written once) through load_whisper_hf;
    whisper_wave through log_mel_spectrogram (128 mels) and
    pad_or_trim(WHISPER_FRAMES), then transcribe_greedy (K4's f32 form twice
    a decoder layer a step: over the f32 self cache and the cross K / V);
    against force_ref(): the encoder states, each step's logits on the
    card's tokens, and the tokens up to the first plain top-2 gap under the
    step bound; the cached tokens against the uncached decoder's (the
    oracle); encode ms, decode tok/s and the device-busy share of the
    encoder and of 8 decode steps. Returns the launches."""
    from zgml_tpu_torch.data.audio import log_mel_spectrogram, pad_or_trim
    from zgml_tpu_torch.io.hf_loaders import load_whisper_hf
    from zgml_tpu_torch.models.whisper import WhisperConfig
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.profile import global_profile
    set_path("default")
    cfg = WhisperConfig(**WHISPER_V3)
    path = (ROOT / ".bench_cache" / f"whisper-large-v3-hf-f16-seed{SEED}-std{WEIGHT_STD}"
            / "model.safetensors")
    write_f16_checkpoint(torch, dev, path, whisper_spec(cfg),
                         {"encoder_attention_heads": cfg.n_audio_heads,
                          "decoder_attention_heads": cfg.n_text_heads})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_whisper_hf(str(path), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(model.cfg == cfg, f"[whisper_large_v3] load_whisper_hf inferred {model.cfg}")
    log(f"  [whisper_large_v3] load_whisper_hf {load_s:.2f} s (heads from config.json): {cfg}")
    t0 = time.perf_counter()
    mel = pad_or_trim(log_mel_spectrogram(whisper_wave(), cfg.n_mels, device=dev),
                      WHISPER_FRAMES)[None]
    torch.cuda.synchronize()
    mel_s = time.perf_counter() - t0
    require(tuple(mel.shape) == (1, WHISPER_FRAMES, cfg.n_mels) and bool(torch.isfinite(mel).all()),
            f"[whisper_large_v3] log-mel features {tuple(mel.shape)}")
    torch.cuda.synchronize()
    global_profile.reset()
    toks = model.transcribe_greedy(mel, WHISPER_BOS, WHISPER_EOS, WHISPER_TOKENS)
    torch.cuda.synchronize()
    steps = len(toks) - 1
    launches, tiers = path_launches("whisper_large_v3", ("decode_attention_f32",))
    want = 2 * cfg.n_text_layers * steps
    require(launches["decode_attention_f32"] == want,
            f"[whisper_large_v3] decode_attention_f32 launched {launches['decode_attention_f32']} "
            f"times, want {want} (2 x {cfg.n_text_layers} layers x {steps} steps)")
    require(toks[0] == WHISPER_BOS and all(0 <= t < cfg.vocab_size for t in toks),
            f"[whisper_large_v3] transcribe_greedy gave {toks}")
    log(f"  [whisper_large_v3] placement: {tiers}")
    log(f"  [whisper_large_v3] {WHISPER_SECONDS} s of audio ({mel_s * 1e3:.1f} ms of log-mel "
        f"frontend) -> {toks}")

    # against force_ref(): the encoder states (no kernel: the same torch ops)
    enc = model.encode_features(mel)
    embd = model.params["tok_embd"]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def nudged(x):
        return x * (1 + SENS_EPS * torch.randn(x.shape, device=dev, generator=g))
    with force_ref():
        enc_r = model.encode_features(mel)
        enc_moves = [float((model.encode_features(nudged(mel)) - enc_r).abs().max())
                     for _ in range(WHISPER_SENS_DRAWS)]
    enc_err = float((enc - enc_r).abs().max())
    enc_bound = max(WHISPER_RTOL * float(enc_r.abs().max()), SENS_MARGIN * max(enc_moves))
    require(enc_err <= enc_bound, f"[whisper_large_v3] encoder states max_abs_err {enc_err:.4g} "
            f"> bound {enc_bound:.4g}")

    def step_logits(feed):
        """Each step's logits with the tokens `feed` fed in turn (the card's)."""
        cross, cache, out = model.precompute_cross_kv(enc), model.init_cache(1), []
        for i, t in enumerate(feed):
            lg, cache = model.decode_step([[t]], cross, cache, i)
            out.append(lg[0])
        return torch.stack(out)
    feed = toks[:-1]
    got = step_logits(feed)
    ids = sorted(set(feed))
    rows = embd[ids].clone()
    with force_ref():
        want_l = step_logits(feed)
        moves = []
        for _ in range(WHISPER_SENS_DRAWS):
            embd[ids] = nudged(rows)
            moves.append((step_logits(feed) - want_l).abs().amax(dim=-1))
        embd[ids] = rows
        ref_toks = model.transcribe_greedy(mel, WHISPER_BOS, WHISPER_EOS, WHISPER_TOKENS)
        ref_gaps = [top2_gap(lg) for lg in step_logits(ref_toks[:-1])]
    move = torch.stack(moves).amax(dim=0)
    scale = want_l.abs().amax(dim=-1)
    errs = (got - want_l).abs().amax(dim=-1)
    bounds = torch.maximum(WHISPER_RTOL * scale, SENS_MARGIN * move)
    require(bool(torch.isfinite(got).all()) and bool((errs <= bounds).all()),
            f"[whisper_large_v3] step logits: max_abs_err {errs.tolist()} > bounds "
            f"{bounds.tolist()}")
    gap_bound = float((bounds / scale).max()) * float(scale.max())
    n_cmp = next((i for i, gap in enumerate(ref_gaps) if gap < gap_bound), len(ref_gaps))
    require(toks[:n_cmp + 1] == ref_toks[:n_cmp + 1],
            f"[whisper_large_v3] tokens differ from force_ref()'s before step {n_cmp}: {toks} vs "
            f"{ref_toks}")
    # the cached decode against the uncached decoder (whisper.py's oracle)
    unc, unc_gaps = [WHISPER_BOS], []
    for _ in range(steps):
        lg = model.decode([unc], enc)[0, -1]
        unc_gaps.append(top2_gap(lg))
        unc.append(int(torch.argmax(lg)))
    n_unc = next((i for i, gap in enumerate(unc_gaps) if gap < gap_bound), steps)
    require(toks[:n_unc + 1] == unc[:n_unc + 1],
            f"[whisper_large_v3] cached tokens {toks} differ from the uncached decoder's {unc} "
            f"before step {n_unc}")
    log(f"  [whisper_large_v3] vs force_ref(): encoder states max_abs_err {enc_err:.3g} (bound "
        f"{enc_bound:.3g}); step logits max_abs_err {float((errs / scale).max()):.3g} of "
        f"max|logit| (bound {float((bounds / scale).min()):.3g}-"
        f"{float((bounds / scale).max()):.3g}; the plain path moves "
        f"{float((move / scale).max()):.3g} under {SENS_EPS:g} perturbations); tokens equal over "
        f"the first {n_cmp} of {steps} steps (all: {toks == ref_toks}); the uncached decoder's "
        f"over {n_unc} (all: {toks == unc})")

    # rates and device busy
    enc_s, dec_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = model.encode_features(mel)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        cross, cache = model.precompute_cross_kv(enc), model.init_cache(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = WHISPER_BOS
        for i in range(WHISPER_TOKENS):
            lg, cache = model.decode_step([[tok]], cross, cache, i)
            tok = int(torch.argmax(lg[0]))
        dec_s.append(time.perf_counter() - t0)
    cross, cache = model.precompute_cross_kv(enc), model.init_cache(1)

    def eight_steps():
        for i in range(8):
            model.decode_step([[WHISPER_BOS]], cross, cache, i)
    busy = dict(encode=device_busy(torch, lambda: model.encode_features(mel)),
                decode8=device_busy(torch, eight_steps))
    rates = dict(encode_ms=1e3 * statistics.median(enc_s),
                 decode_tok_s=WHISPER_TOKENS / statistics.median(dec_s), encode_runs_s=enc_s,
                 decode_runs_s=dec_s, card=card)
    log(f"  [whisper_large_v3] encode {rates['encode_ms']:.1f} ms ({WHISPER_FRAMES} frames), "
        f"decode {rates['decode_tok_s']:.1f} tok/s ({WHISPER_TOKENS} steps with their argmax "
        f"read back; medians of 3); encoder: {busy_text(*busy['encode'])}; 8 decode steps: "
        f"{busy_text(*busy['decode8'])}  [{card}]")
    summary["whisper_large_v3"] = dict(
        config=WHISPER_V3, load_s=load_s, mel_s=mel_s, launches=launches, placement=tiers,
        outputs=toks, ref_outputs=ref_toks, uncached_outputs=unc, encoder_err=enc_err,
        encoder_bound=enc_bound, step_errs=errs.tolist(), step_bounds=bounds.tolist(),
        tokens_checked=n_cmp, uncached_checked=n_unc, rates=rates,
        busy={k: dict(wall_us=w, device_busy_us=b) for k, (w, b) in busy.items()})
    del model, cross, cache, enc
    torch.cuda.empty_cache()
    return launches


# -- phase 3's parallel paths: ranks that share the card over gloo -----------------------

_RANK_STATE = {}       # a rank's engine between two World.run calls of one path


def _rank_counts() -> dict:
    """A rank's placement counts {op: {tier: n}} and its counters."""
    from zgml_tpu_torch.runtime.profile import global_profile
    return dict(tiers=global_profile.tier_summary(), counters=dict(global_profile.counters))


def tp2_rank(dev, path: str, prompt, n_new: int) -> dict:
    """tp2_7b on one rank: the GGUF loaded on the CPU, this rank's shard on
    the card (parallel/tp.shard_llama_params), a PAR_CHUNK-row prefill of
    `prompt` and n_new greedy tokens (the first from the prefill's logits)
    through LlamaEngine, each timed on the host clock (synchronized); the
    device-busy share of 8 decode steps after them."""
    import torch
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.parallel import make_mesh, shard_llama_params
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    t0 = time.perf_counter()
    model, gf = load_llama(path, device="cpu")
    gf.close()
    mesh = make_mesh(tp=2, dp=1, device=dev)
    shard_llama_params(model, mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = LlamaEngine(model, prefill_chunk=PAR_CHUNK)
    eng.prefill(prompt)                    # once to warm up, then from 0 counted
    eng.reset()
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    logits = eng.prefill(prompt)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    toks = eng.decode_n(tok, n_new - 1)
    torch.cuda.synchronize()
    tg_s = time.perf_counter() - t0
    counts = _rank_counts()
    wall_us, busy_us = device_busy(torch, lambda: [eng.step(tok) for _ in range(8)])
    plain = rank_plain(torch, eng, prompt, n_new)
    _RANK_STATE["tp2"] = eng
    return dict(logits=logits.cpu().numpy(), tokens=[int(tok[0])] + toks[:, 0].tolist(),
                load_s=load_s, pp_s=pp_s, tg_s=tg_s, busy_wall_us=wall_us, busy_us=busy_us,
                plain=plain, **counts)


def rank_plain(torch, eng, prompt, n_new: int) -> dict:
    """A rank's engine on its own shards against force_ref() (every rank
    together: the collectives run on both tiers): the prefill logits, one
    decode step from the kernels' cache after it, and n_new plain greedy
    tokens with their top-2 gaps (the first from the plain prefill's
    logits); the main process holds them to the plain path's bounds
    (check_rank_plain)."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    eng.reset()
    logits = eng.prefill(prompt)
    tok0 = torch.argmax(logits, dim=-1)
    saved, pos0 = {k: v.clone() for k, v in eng.cache.items()}, eng.pos

    def step():
        for k, v in saved.items():
            eng.cache[k].copy_(v)
        eng.pos = pos0
        return eng.step(tok0)[1]
    step_k = step()
    with force_ref():
        step_r = step()
        eng.reset()
        logits_r = eng.prefill(prompt)
        toks, gaps = greedy_with_gaps(torch, eng, int(torch.argmax(logits_r[0])), n_new)
    del saved
    torch.cuda.empty_cache()
    return dict(err_p=float((logits - logits_r).abs().max()), scale_p=float(logits_r.abs().max()),
                err_s=float((step_k - step_r).abs().max()), scale_s=float(step_r.abs().max()),
                finite=bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_k).all()),
                tokens=toks, gaps=[top2_gap(logits_r[0])] + gaps)


def tp2_step_rank(dev, k, v, tok: int, pos: int) -> dict:
    """One decode step of tp2_7b's engine from a shared cache: this rank's KV
    heads of the bf16 cache rows k / v (int16 views [L, 1, Hkv, pos, hd])."""
    import torch
    eng = _RANK_STATE.pop("tp2")
    tp = eng.model.tp
    h = eng.cache["k"].shape[2]
    for name, src in (("k", k), ("v", v)):
        rows = torch.from_numpy(src[:, :, tp.rank * h:(tp.rank + 1) * h]).view(torch.bfloat16)
        eng.cache[name][:, :, :, :pos] = rows.to(eng.cache[name].device)
    eng.pos = pos
    with torch.inference_mode():
        _, logits = eng.step(torch.tensor([tok]))
    return dict(logits=logits.cpu().numpy())


def cp2_rank(dev, path: str, prompt, n_new: int, cache_dtype: str) -> dict:
    """cp2_tiny on one rank: the whole model on the card, LlamaEngine.
    prefill_cp of `prompt` over the 2-rank 'cp' axis (timed, host clock),
    then n_new greedy tokens on the normal path; the cache's first len(prompt)
    positions (int16 views of bf16, or int8 levels and f32 scales)."""
    import torch
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.parallel import make_mesh
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    model = _RANK_STATE.get("cp2_model")
    if model is None:
        model, gf = load_llama(path, device=dev)
        gf.close()
        _RANK_STATE["cp2_model"] = model
    mesh = make_mesh(tp=2, dp=1, axis_names=("dp", "cp"), device=dev)
    eng = LlamaEngine(model, prefill_chunk=PAR_CHUNK, cache_dtype=cache_dtype)
    eng.prefill_cp(prompt, mesh)           # once to warm up, then from 0 counted
    eng.reset()
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    last = eng.prefill_cp(prompt, mesh)
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    prefill_counts = _rank_counts()
    tok = torch.argmax(last, dim=-1)
    tok1, step = eng.step(tok)
    toks = eng.decode_n(tok1, n_new - 2)
    t = len(prompt)
    cache = {name: (c[:, :, :, :t].view(torch.int16) if c.dtype == torch.bfloat16
                    else c[:, :, :, :t]).cpu().numpy() for name, c in eng.cache.items()}
    return dict(last=last.cpu().numpy(), step=step.cpu().numpy(),
                tokens=[int(tok[0]), int(tok1[0])] + toks[:, 0].tolist(), pp_s=pp_s,
                prefill=prefill_counts, cache=cache, **_rank_counts())


def cp2_f32_rank(dev, path: str, prompt) -> dict:
    """cp2_tiny under ZGML_TPU_PREFILL_BF16=0 on one rank (the model cp2_rank
    loaded): LlamaEngine.prefill_cp of `prompt` with the kernels (counted:
    K2's f32 form, K10f's f32-K/V form a ring hop), then under force_ref()
    on the same ranks; both last logits."""
    import torch
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.parallel import make_mesh
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    from zgml_tpu_torch.runtime.profile import global_profile
    os.environ["ZGML_TPU_PREFILL_BF16"] = "0"
    try:
        mesh = make_mesh(tp=2, dp=1, axis_names=("dp", "cp"), device=dev)
        eng = LlamaEngine(_RANK_STATE["cp2_model"], prefill_chunk=PAR_CHUNK)
        eng.prefill_cp(prompt, mesh)           # once to warm up, then from 0 counted
        eng.reset()
        torch.cuda.synchronize()
        global_profile.reset()
        last = eng.prefill_cp(prompt, mesh)
        torch.cuda.synchronize()
        counts = _rank_counts()
        eng.reset()
        with force_ref():
            last_r = eng.prefill_cp(prompt, mesh)
    finally:
        os.environ.pop("ZGML_TPU_PREFILL_BF16", None)
    return dict(last=last.cpu().numpy(), last_r=last_r.cpu().numpy(), **counts)


def serve_rank(dev, path: str, n_layers: int, reqs, tp: int, dp: int) -> dict:
    """serve_mesh_tiny on one rank: the GGUF's first n_layers layers sharded
    over a (dp, tp) mesh of the two ranks, ContinuousBatchingEngine(max_batch
    SERVE_BATCH, prefill_chunk SERVE_CHUNK, mesh=) under drive_server, timed
    (host clock, synchronized)."""
    import torch
    from zgml_tpu_torch.io.llama_loader import load_llama
    from zgml_tpu_torch.parallel import make_mesh, shard_llama_params
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    model, gf = load_llama(path, device="cpu")
    gf.close()
    model = shallow_model(model, n_layers)
    mesh = make_mesh(tp=tp, dp=dp, device=dev)
    shard_llama_params(model, mesh)
    serve = ContinuousBatchingEngine(model, max_batch=SERVE_BATCH, prefill_chunk=SERVE_CHUNK,
                                     mesh=mesh)
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    outs, steps = drive_server(serve, reqs)
    torch.cuda.synchronize()
    out = dict(outs=outs, steps=steps, wall_s=time.perf_counter() - t0, **_rank_counts())
    if tp > 1:      # the same sharded server under force_ref(): its streams and their gaps
        from zgml_tpu_torch.ops.dispatch import force_ref
        with force_ref():
            ref = ContinuousBatchingEngine(model, max_batch=SERVE_BATCH,
                                           prefill_chunk=SERVE_CHUNK, mesh=mesh)
            _, gaps = watch_server(torch, ref, gaps=True)
            out["plain_outs"], _ = drive_server(ref, reqs)
        out["plain_gaps"] = [gaps[rid] for rid in sorted(gaps)]
    return out


def _train_ref(dev) -> dict:
    """A rank's one-process computation for the training paths, made once
    and kept: the dense model (init_params on the CPU, a copy on the card),
    the batch, the first step's loss and gradients, their move under
    SENS_EPS embedding perturbations, and the losses of the later steps."""
    if "train_ref" in _RANK_STATE:
        return _RANK_STATE["train_ref"]
    import dataclasses

    import torch
    from zgml_tpu_torch.models.llama import LlamaModel, init_params
    from zgml_tpu_torch.optim.sgd import sgd_update
    from zgml_tpu_torch.parallel.tp import next_token_nll
    from zgml_tpu_torch.utils.tree import flatten, paths, tree_map
    cfg = dataclasses.replace(preset("tinyllama-1.1b"), n_layers=SHALLOW_LAYERS)
    full = init_params(cfg, seed=SEED, device="cpu")
    tokens = corpus_batches(torch, "cpu", TRAIN_B, TRAIN_T, 1)[0]
    tok_dev = tokens.to(dev)

    def loss_grads(params):
        leaves, _ = flatten(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = next_token_nll(LlamaModel(cfg, params)(tok_dev[:, :-1]), tok_dev)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return float(loss.detach()), list(grads)
    params = tree_map(lambda t: t.to(dev), full)
    loss, grads = loss_grads(params)
    moves = [0.0] * len(grads)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb = params["tok_embd"]
    for _ in range(GRAD_SENS_DRAWS):
        p2 = {**params, "tok_embd": emb * (1 + SENS_EPS * torch.randn(emb.shape, device=dev,
                                                                       generator=gen))}
        moves = [max(m, float((a - b).abs().max())) for m, a, b in zip(moves, loss_grads(p2)[1],
                                                                        grads)]
        del p2
    losses, later = [loss], params
    _, rebuild = flatten(params)
    g = rebuild(grads)
    for _ in range(PAR_TRAIN_STEPS - 1):
        later = sgd_update(later, g, PAR_TRAIN_LR)
        lo, gl = loss_grads(later)
        losses.append(lo)
        g = rebuild(gl)
    del later, g
    names = [n for n, _ in paths(params)]
    ref = dict(cfg=cfg, full=full, tokens=tokens, losses=losses,
               grads=rebuild(grads), moves=dict(zip(names, moves)), params=params)
    _RANK_STATE["train_ref"] = ref
    return ref


def train_rank(dev, name: str) -> dict:
    """One training path of PAR_TRAIN on this rank: the dense model's shard
    for the path's mesh (shard_llama_params, or shard_pp_params), the step
    (make_sharded_train_step or make_pp_train_step, n_micro _choose_micro),
    PAR_TRAIN_STEPS steps on this rank's rows (dp: its half of the batch),
    the first step's loss and gradients counted and timed (the placement
    counts set to 0 just before), and each held to the one-process
    computation (_train_ref) here; the replicated leaves' digests after the
    steps."""
    import hashlib

    import torch
    from zgml_tpu_torch.models.llama import LlamaModel
    from zgml_tpu_torch.optim.sgd import sgd_update
    from zgml_tpu_torch.parallel import (make_mesh, make_pp_train_step,
                                         make_sharded_train_step, shard_llama_params,
                                         shard_pp_params)
    from zgml_tpu_torch.parallel.pp import _choose_micro
    from zgml_tpu_torch.parallel.tp import _split, shard_layer
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.utils.tree import flatten, paths, tree_map
    ref = _train_ref(dev)
    cfg, par = ref["cfg"], PAR_TRAIN[name]
    model = LlamaModel(cfg, tree_map(torch.clone, ref["full"]))
    tokens = ref["tokens"]
    want = ref["grads"]
    if "pp" in par:
        mesh = make_mesh(tp=par["pp"], dp=1, axis_names=("dp", "pp"), device=dev)
        shard_pp_params(model, mesh)
        n_micro = _choose_micro(tokens.shape[0], par["pp"])
        step = make_pp_train_step(model, mesh, n_micro)
        s, per = mesh.coords["pp"], cfg.n_layers // par["pp"]
        want = {**want, "layers": want["layers"][s * per:(s + 1) * per]}
        layer_of = lambda li: s * per + li          # noqa: E731
        replicated = ("tok_embd", "out_norm", "lm_head")
        where = dict(stage=s, n_micro=n_micro)
    else:
        mesh = make_mesh(tp=par["tp"], dp=par["dp"], device=dev)
        shard_llama_params(model, mesh)
        step = make_sharded_train_step(model, mesh)
        tp, t = par["tp"], mesh.coords["tp"]
        b = tokens.shape[0] // par["dp"]
        tokens = tokens[mesh.coords["dp"] * b:(mesh.coords["dp"] + 1) * b]
        if tp > 1:
            want = {"tok_embd": want["tok_embd"], "out_norm": want["out_norm"],
                    "lm_head": _split(want["lm_head"], tp, "n", t),
                    "layers": [shard_layer(ly, cfg, tp, t) for ly in want["layers"]]}
        layer_of = lambda li: li                     # noqa: E731
        replicated = (("tok_embd", "out_norm", "attn_norm", "ffn_norm") if tp > 1 else
                      ("tok_embd", "out_norm", "lm_head", "attn_norm", "ffn_norm", "wq", "wk",
                       "wv", "wo", "w_gate", "w_up", "w_down"))
        where = dict(tp=t, dp=mesh.coords["dp"])
    tok_dev = tokens.to(dev)
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(tok_dev)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = _rank_counts()
    names = [n for n, _ in paths(model.params)]
    wants = flatten(want)[0]
    rows = []
    for n_, got, w in zip(names, grads, wants):
        parts = n_.split("/")
        full_name = f"layers/{layer_of(int(parts[1]))}/{parts[2]}" if parts[0] == "layers" else n_
        err, scale = float((got - w).abs().max()), float(w.abs().max())
        move = ref["moves"][full_name]
        rows.append(dict(tensor=n_, err=err, scale=scale, plain_move=move,
                         bound=max(GRAD_RTOL * scale, SENS_MARGIN * move),
                         finite=bool(torch.isfinite(got).all())))
    losses = [float(loss)]
    _, rebuild = flatten(model.params)
    model.params = sgd_update(model.params, rebuild(grads), PAR_TRAIN_LR)
    del grads
    for _ in range(PAR_TRAIN_STEPS - 1):
        lo, _ = step(tok_dev, PAR_TRAIN_LR)
        losses.append(float(lo))
    torch.cuda.synchronize()
    digests = {n_: hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()
               for n_, t in paths(model.params) if n_.split("/")[-1] in replicated}
    del model, step
    torch.cuda.empty_cache()
    return dict(losses=losses, want_losses=ref["losses"], grads=rows, digests=digests,
                step_ms=step_ms, where=where, **counts)


def pp_forward_rank(dev, prompts, n_new: int) -> dict:
    """pp2_tiny on this rank: the dense model's stage (shard_pp_params),
    make_pp_forward over a stage cache of one row a prompt (prompts int
    [B, T], n_micro _choose_micro(B, 2)): the prefill, then n_new - 1 greedy
    tokens a row, one pipeline forward each (the first from the prefill),
    each timed on the host clock; each call's last-position logits [B, V]."""
    import torch
    from zgml_tpu_torch.models.llama import LlamaModel
    from zgml_tpu_torch.parallel import make_mesh, make_pp_forward, shard_pp_params
    from zgml_tpu_torch.runtime.profile import global_profile
    from zgml_tpu_torch.utils.tree import tree_map
    ref = _train_ref(dev)
    model = LlamaModel(ref["cfg"], tree_map(torch.clone, ref["full"]))
    mesh = make_mesh(tp=PAR_RANKS, dp=1, axis_names=("dp", "pp"), device=dev)
    shard_pp_params(model, mesh)
    fwd = make_pp_forward(model, mesh)
    x = torch.as_tensor(np.asarray(prompts, np.int64))
    cache = model.init_cache(x.shape[0])
    torch.cuda.synchronize()
    global_profile.reset()
    t0 = time.perf_counter()
    logits = fwd(x, cache, 0)[:, -1]
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    tok, toks, steps = torch.argmax(logits, -1), [], []
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        toks.append(tok.tolist())
        lg = fwd(tok[:, None], cache, x.shape[1] + i)[:, -1]
        steps.append(lg)
        tok = torch.argmax(lg, -1)
    toks.append(tok.tolist())
    torch.cuda.synchronize()
    tg_s = time.perf_counter() - t0
    counts = _rank_counts()
    return dict(logits=logits.cpu().numpy(), steps=torch.stack(steps).cpu().numpy(),
                tokens=np.asarray(toks).T.tolist(), pp_s=pp_s, tg_s=tg_s,
                stage=mesh.coords["pp"], **counts)


def rank_launches(name, results, kernels):
    """The path's launches {kernel: n} summed over the ranks, after the rule
    of every path on each rank (path_launches)."""
    per_rank = [path_launches(f"{name} rank {r}", kernels, tiers=res["tiers"])[0]
                for r, res in enumerate(results)]
    return {k: sum(p[k] for p in per_rank) for k in KERNELS}


def greedy_with_gaps(torch, eng, tok0: int, n: int):
    """n - 1 greedy steps of `eng` after tok0: the n tokens and each one's
    top-2 gap (the logits it was the argmax of; the first from the prefill's,
    given by the caller)."""
    toks, gaps, tok = [tok0], [], torch.tensor([tok0])
    for _ in range(n - 1):
        tok, lg = eng.step(tok)
        toks.append(int(tok[0]))
        gaps.append(top2_gap(lg[0]))
    return toks, gaps


def check_rank_plain(label, p, tokens, bound_p: float, bound_s: float) -> dict:
    """A rank's kernels against its own plain versions on the same shards
    (rank_plain): prefill logits and the decode step within the plain
    path's bounds (plain_envelope's of the model), its tokens equal to the
    plain greedy tokens up to the first plain top-2 gap under the step bound
    (relative; FLIP_PATHS' rule: K7-i8 and K6c quantize per token). Logs
    and returns the figures."""
    require(p["finite"] and p["err_p"] <= bound_p and p["err_s"] <= bound_s,
            f"[{label}] vs force_ref() on its shards: prefill logits {p['err_p']:.4g} (bound "
            f"{bound_p:.4g}), decode step {p['err_s']:.4g} (bound {bound_s:.4g}), or not finite")
    gap_bound = bound_s / p["scale_s"] * p["scale_p"]
    n_cmp = next((i for i, gap in enumerate(p["gaps"]) if gap < gap_bound), len(tokens))
    require(tokens[:n_cmp] == p["tokens"][:n_cmp],
            f"[{label}] tokens differ from force_ref()'s on its shards before step {n_cmp}: "
            f"{tokens} vs {p['tokens']}")
    log(f"  [{label}] vs force_ref() on its shards: prefill logits {p['err_p']:.4g} "
        f"({p['err_p'] / p['scale_p']:.3g} of max|logit|; bound {bound_p:.4g}); decode step "
        f"from a shared cache {p['err_s']:.4g} ({p['err_s'] / p['scale_s']:.3g}; bound "
        f"{bound_s:.4g}); tokens equal over the first {n_cmp} of {len(tokens)} (plain top-2 "
        f"gap bound {gap_bound:.3g}), all equal {tokens == p['tokens']}")
    return dict(err_p=p["err_p"], err_s=p["err_s"], scale_p=p["scale_p"], scale_s=p["scale_s"],
                plain_tokens=p["tokens"], tokens_checked=n_cmp, gap_bound=gap_bound,
                all_equal=tokens == p["tokens"])


def tp2_path(torch, world, model, prompt, card, summary):
    """tp2_7b: Llama-2-7B Q4_0 at full width and depth, tensor-parallel over
    the two ranks (module note, phase 3); returns the launches."""
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    name = "tp2_7b"
    path = str(model_path("llama2-7b", "q4_0"))
    res = world.run(tp2_rank, path, prompt, PAR_NEW, timeout=PAR_TIMEOUT)
    launches = rank_launches(name, res, PAR_KERNELS[name])
    require(all(np.array_equal(r["logits"], res[0]["logits"]) and r["tokens"] == res[0]["tokens"]
                for r in res), f"[{name}] the ranks' logits or tokens differ")
    one = LlamaEngine(model, prefill_chunk=PAR_CHUNK)
    env = plain_envelope(torch, one, prompt, PAR_SENS_DRAWS)
    want = env["logits"].cpu().numpy()
    got = res[0]["logits"]
    scale_p = float(np.abs(want).max())
    err_p = float(np.abs(got - want).max())
    require(np.isfinite(got).all() and got.shape == want.shape and err_p <= env["bound_p"],
            f"[{name}] prefill logits {err_p:.4g} from one process's (bound {env['bound_p']:.4g})")
    k, v = (env["saved"][n][:, :, :, :env["pos"]].view(torch.int16).cpu().numpy()
            for n in ("k", "v"))
    steps = world.run(tp2_step_rank, k, v, int(env["tok0"][0]), env["pos"], timeout=PAR_TIMEOUT)
    step_k = env["step"].cpu().numpy()
    scale_s = float(np.abs(step_k).max())
    err_s = float(np.abs(steps[0]["logits"] - step_k).max())
    require(err_s <= env["bound_s"] and all(np.array_equal(s["logits"], steps[0]["logits"])
                                            for s in steps),
            f"[{name}] decode step from a shared cache {err_s:.4g} from one process's (bound "
            f"{env['bound_s']:.4g})")
    # tokens: the one-process engine's, equal up to its first top-2 gap under
    # the step bound (relative; FLIP_PATHS' rule: K7-i8 and K6c quantize per token)
    one.reset()
    first = one.prefill(prompt)
    ref, gaps = greedy_with_gaps(torch, one, int(torch.argmax(first[0])), PAR_NEW)
    gaps = [top2_gap(first[0])] + gaps
    gap_bound = env["bound_s"] / scale_s * scale_p
    n_cmp = next((i for i, gap in enumerate(gaps) if gap < gap_bound), PAR_NEW)
    require(res[0]["tokens"][:n_cmp] == ref[:n_cmp],
            f"[{name}] tokens differ before step {n_cmp}: {res[0]['tokens']} vs {ref}")
    plain = [check_rank_plain(f"{name} rank {i}", r["plain"], r["tokens"], env["bound_p"],
                              env["bound_s"]) for i, r in enumerate(res)]
    pp = [PAR_PROMPT / r["pp_s"] for r in res]
    tg = [(PAR_NEW - 1) / r["tg_s"] for r in res]
    copies = [r["counters"].get("host_copies", 0) for r in res]
    log(f"  [{name}] tp 2 over 2 gloo ranks sharing one card: placement rank 0 "
        f"{res[0]['tiers']}; host copies per rank {copies} "
        f"({[r['counters'].get('host_copy_bytes', 0) for r in res]} bytes)")
    log(f"  [{name}] prefill logits {err_p:.4g} from one process's ({err_p / scale_p:.3g} of "
        f"max|logit|; bound {env['bound_p']:.4g}); decode step from a shared cache {err_s:.4g} "
        f"({err_s / scale_s:.3g}; bound {env['bound_s']:.4g}); tokens equal over the first "
        f"{n_cmp} of {PAR_NEW} (gap bound {gap_bound:.3g}), all equal {res[0]['tokens'] == ref}")
    log(f"  [{name}] pp{PAR_PROMPT} {min(pp):.1f} tok/s, tg{PAR_NEW} {min(tg):.1f} tok/s "
        f"(slower rank; host clock, ranks sharing one card over gloo, not a multi-card rate); "
        f"8 decode steps per rank: "
        + "; ".join(busy_text(r["busy_wall_us"], r["busy_us"]) for r in res) + f"  [{card}]")
    summary.setdefault("parallel", {})[name] = dict(
        launches=launches, placement=[r["tiers"] for r in res], host_copies=copies,
        host_copy_bytes=[r["counters"].get("host_copy_bytes", 0) for r in res],
        logits_err=err_p, logits_bound=env["bound_p"], logits_scale=scale_p,
        logits_sensitivity=env["sens_p"], logits_sensitivity_proj_out=env["sens_o"],
        step_err=err_s, step_bound=env["bound_s"], step_sensitivity=env["sens_s"],
        tokens=res[0]["tokens"], one_process_tokens=ref, tokens_checked=n_cmp,
        vs_plain_on_shards=plain, pp_tok_s=pp, tg_tok_s=tg, load_s=[r["load_s"] for r in res],
        busy=[dict(wall_us=r["busy_wall_us"], busy_us=r["busy_us"]) for r in res], card=card,
        backend="gloo", ranks=2)
    return launches


def cp2_path(torch, world, model, prompt, card, summary):
    """cp2_tiny: TinyLlama-1.1B Q4_0, context-parallel prefill over the two
    ranks (module note, phase 3); returns the launches."""
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    name = "cp2_tiny"
    path = str(model_path("tinyllama-1.1b", "q4_0"))
    runs = {c: world.run(cp2_rank, path, prompt, PAR_NEW, c, timeout=PAR_TIMEOUT)
            for c in ("bf16", "int8")}
    layers = model.cfg.n_layers
    launches = {k: 0 for k in KERNELS}
    for c, res in runs.items():
        for k, n in rank_launches(f"{name} {c}", res, PAR_KERNELS[f"{name}_{c}"]).items():
            launches[k] += n
        # the prefill's ring hops: rank idx runs idx + 1 of its 2 a layer, each one
        # K10f launch (its bf16 form), and one ring call a layer
        for idx, r in enumerate(res):
            pre = r["prefill"]
            k10 = pre["tiers"].get("flash_fwd_bf16", {}).get("cuda", 0)
            require(k10 == layers * (idx + 1) == pre["counters"].get("ring_hops")
                    and pre["tiers"].get("ring_attention", {}).get("cuda") == layers,
                    f"[{name} {c}] rank {idx}: K10f launched {k10} times in the prefill, "
                    f"want {layers * (idx + 1)} ({pre['counters']})")
        require(all(np.array_equal(r["last"], res[0]["last"]) for r in res),
                f"[{name} {c}] the ranks' last logits differ")
        require(all(np.array_equal(r["cache"][n], res[0]["cache"][n])
                    for r in res for n in res[0]["cache"]),
                f"[{name} {c}] the ranks' caches differ")
    # bf16: against the engine's chunked prefill of the same prompt
    one = LlamaEngine(model, prefill_chunk=PAR_CHUNK)
    env = plain_envelope(torch, one, prompt, PAR_SENS_DRAWS)
    want, got = env["logits"].cpu().numpy(), runs["bf16"][0]["last"]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    require(np.isfinite(got).all() and err <= env["bound_p"],
            f"[{name}] last logits {err:.4g} from the chunked prefill's (bound "
            f"{env['bound_p']:.4g})")
    t = len(prompt)
    rel = env["bound_p"] / scale
    cache_err = {}
    for n in ("k", "v"):
        ref = env["saved"][n][:, :, :, :t].float().cpu().numpy()
        mine = torch.from_numpy(runs["bf16"][0]["cache"][n]).view(torch.bfloat16).float().numpy()
        d = np.abs(mine - ref)
        ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(mine), np.abs(ref)))[1] - 8)
        floor0 = 1e-5 * float(np.abs(ref[0]).max())
        cache_err[n] = dict(layer0_over=float((d[0] / np.maximum(ulp[0], floor0)).max()),
                            rel=float(d.max() / np.abs(ref).max()))
        # layer 0's K/V are the projection of the embeddings alone (K2's bf16
        # form over 768 rows here, 128 there: f32 sums in another order), so one
        # bf16 ulp, or 1e-5 of max|K| where a value near zero flips by more
        # ulps; later layers carry the logits' relative envelope (at least 2 ulps)
        require(cache_err[n]["layer0_over"] <= 1 and cache_err[n]["rel"] <= max(rel, 2.0 ** -7),
                f"[{name}] cache {n} vs the chunked prefill's: {cache_err[n]} (relative bound "
                f"{max(rel, 2.0 ** -7):.3g})")
    one.reset()
    first = one.prefill(prompt)
    ref_toks, gaps = greedy_with_gaps(torch, one, int(torch.argmax(first[0])), PAR_NEW)
    gaps = [top2_gap(first[0])] + gaps
    gap_bound = env["bound_s"] / float(env["step"].abs().max()) * scale
    n_cmp = next((i for i, gap in enumerate(gaps) if gap < gap_bound), PAR_NEW)
    toks = runs["bf16"][0]["tokens"]
    require(toks[:n_cmp] == ref_toks[:n_cmp],
            f"[{name}] tokens after prefill_cp differ before step {n_cmp}: {toks} vs {ref_toks}")
    # int8: the same prefill (its logits do not read the cache), its cache the
    # bf16 run's K/V quantized per position: within half a level plus half a
    # bf16 ulp of them
    i8 = runs["int8"][0]
    require(np.array_equal(i8["last"], got), f"[{name}] int8: last logits differ from bf16's")
    for n in ("k", "v"):
        deq = i8["cache"][n].astype(np.float32) * i8["cache"][f"{n}_s"][..., None]
        b16 = torch.from_numpy(runs["bf16"][0]["cache"][n]).view(torch.bfloat16).float().numpy()
        ulp = np.ldexp(1.0, np.frexp(np.abs(b16))[1] - 8)
        lim = 0.5 * i8["cache"][f"{n}_s"][..., None] * (1 + 1e-6) + 0.5 * ulp
        require(bool(np.all(np.abs(deq - b16) <= lim)),
                f"[{name}] int8 cache {n}: not the bf16 run's K/V quantized per position")
    vocab = model.cfg.vocab_size
    require(all(len(r[0]["tokens"]) == PAR_NEW and all(0 <= x < vocab for x in r[0]["tokens"])
                for r in runs.values()), f"[{name}] decode after prefill_cp gave bad tokens")
    kv8 = check_cp_int8_decode(torch, model, prompt, i8, name)
    f32 = check_cp_f32(torch, world, path, prompt, layers, launches, name)
    pp = {c: [t / r["pp_s"] for r in res] for c, res in runs.items()}
    log(f"  [{name}] cp 2 over 2 gloo ranks sharing one card: prefill placement rank 1 "
        f"{runs['bf16'][1]['prefill']['tiers']}; host copies per rank "
        f"{[r['counters'].get('host_copies', 0) for r in runs['bf16']]}")
    log(f"  [{name}] last logits {err:.4g} from the chunked prefill's ({err / scale:.3g} of "
        f"max|logit|; bound {env['bound_p']:.4g}); cache {cache_err}; tokens equal over the "
        f"first {n_cmp} of {PAR_NEW}; int8 run: logits bit-equal, cache the K/V quantized; "
        f"its tokens {i8['tokens']}")
    log(f"  [{name}] pp{t} " + ", ".join(f"{c} cache {min(v):.1f} tok/s" for c, v in pp.items())
        + f" (slower rank; host clock, ranks sharing one card over gloo)  [{card}]")
    summary.setdefault("parallel", {})[name] = dict(
        launches=launches, placement={c: [r["tiers"] for r in res] for c, res in runs.items()},
        prefill_placement={c: [r["prefill"] for r in res] for c, res in runs.items()},
        logits_err=err, logits_bound=env["bound_p"], logits_scale=scale, cache_err=cache_err,
        tokens={c: res[0]["tokens"] for c, res in runs.items()}, chunked_tokens=ref_toks,
        tokens_checked=n_cmp, int8_decode=kv8, prefill_f32=f32, pp_tok_s=pp, prompt=t,
        card=card, backend="gloo", ranks=2)
    return launches


def check_cp_int8_decode(torch, model, prompt, i8, name) -> dict:
    """cp2_tiny's int8 run after prefill_cp: its first decode step (K7's
    int8-cache mode over the cache the ranks wrote) and its tokens against a
    one-process int8 LlamaEngine given that same cache (rank 0's first t
    positions) under force_ref(): the step within the int8 path's
    plain_envelope step bound, the tokens equal up to the first plain top-2
    gap under that bound (relative; the int8 cache flips per token)."""
    from zgml_tpu_torch.ops.dispatch import force_ref
    from zgml_tpu_torch.runtime.engine import LlamaEngine
    t = len(prompt)
    one = LlamaEngine(model, prefill_chunk=PAR_CHUNK, cache_dtype="int8")
    env = plain_envelope(torch, one, prompt, PAR_SENS_DRAWS)
    del env["saved"]

    def from_cp_cache():
        one.reset()
        for n, c in one.cache.items():
            c[:, :, :, :t] = torch.from_numpy(i8["cache"][n]).to(c.device)
        one.pos = t
    tok0 = int(np.argmax(i8["last"][0]))
    with force_ref():
        from_cp_cache()
        step_r = one.step(torch.tensor([tok0]))[1].cpu().numpy()
        from_cp_cache()
        toks_r, gaps = greedy_with_gaps(torch, one, tok0, PAR_NEW)
    gaps = [top2_gap(torch.from_numpy(i8["last"][0]))] + gaps
    scale_s = float(np.abs(step_r).max())
    err = float(np.abs(i8["step"] - step_r).max())
    require(bool(np.isfinite(i8["step"]).all()) and err <= env["bound_s"],
            f"[{name} int8] decode step from the cache prefill_cp wrote {err:.4g} from "
            f"force_ref()'s on the same cache (bound {env['bound_s']:.4g})")
    gap_bound = env["bound_s"] / float(env["step_r"].abs().max()) * float(
        env["logits_r"].abs().max())
    n_cmp = next((i for i, gap in enumerate(gaps) if gap < gap_bound), PAR_NEW)
    require(i8["tokens"][:n_cmp] == toks_r[:n_cmp],
            f"[{name} int8] tokens after prefill_cp differ from force_ref()'s on the same cache "
            f"before step {n_cmp}: {i8['tokens']} vs {toks_r}")
    log(f"  [{name} int8] decode from the cache prefill_cp wrote vs force_ref() on the same "
        f"cache: first step {err:.4g} ({err / scale_s:.3g} of max|logit|; bound "
        f"{env['bound_s']:.4g}); tokens equal over the first {n_cmp} of {PAR_NEW} (plain top-2 "
        f"gap bound {gap_bound:.3g}), all equal {i8['tokens'] == toks_r}")
    return dict(step_err=err, step_bound=env["bound_s"], step_scale=scale_s,
                step_sensitivity=env["sens_s"], tokens_checked=n_cmp, gap_bound=gap_bound,
                plain_tokens=toks_r, all_equal=i8["tokens"] == toks_r)


def check_cp_f32(torch, world, path, prompt, layers, launches, name) -> dict:
    """cp2_tiny's prefill under ZGML_TPU_PREFILL_BF16=0 (cp2_f32_rank): each
    rank launches K2's f32 form and K10f's f32-K/V form, idx + 1 hops a
    layer on rank idx, no plain version; the ranks' last logits equal, and
    within LOGIT_RTOL * max of the same prefill_cp under force_ref() (f32
    throughout: sums in another order). Adds the launches to `launches`."""
    res = world.run(cp2_f32_rank, path, prompt, timeout=PAR_TIMEOUT)
    for k, n in rank_launches(f"{name} f32", res, PAR_KERNELS["cp2_tiny_f32"]).items():
        launches[k] += n
    for idx, r in enumerate(res):
        k10 = r["tiers"].get("flash_fwd_f32kv", {}).get("cuda", 0)
        require(k10 == layers * (idx + 1) == r["counters"].get("ring_hops")
                and r["tiers"].get("ring_attention", {}).get("cuda") == layers,
                f"[{name} f32] rank {idx}: K10f's f32-K/V form launched {k10} times, want "
                f"{layers * (idx + 1)} ({r['counters']})")
    require(all(np.array_equal(r["last"], res[0]["last"]) for r in res),
            f"[{name} f32] the ranks' last logits differ")
    got, want = res[0]["last"], res[0]["last_r"]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    require(bool(np.isfinite(got).all()) and err <= LOGIT_RTOL * scale,
            f"[{name} f32] last logits {err:.4g} from force_ref()'s (bound "
            f"{LOGIT_RTOL * scale:.4g})")
    log(f"  [{name} f32] ZGML_TPU_PREFILL_BF16=0: placement rank 1 {res[1]['tiers']}; last "
        f"logits {err:.4g} from force_ref()'s on the same ranks ({err / scale:.3g} of "
        f"max|logit|; bound {LOGIT_RTOL:g} of max)")
    return dict(logits_err=err, logits_bound=LOGIT_RTOL * scale, logits_scale=scale,
                placement=[r["tiers"] for r in res])


def serve_mesh_path(torch, world, model, reqs, card, summary):
    """serve_mesh_tiny: serve_tiny's traffic over the two ranks at (dp 1,
    tp 2) and (dp 2, tp 1) on `model` (TinyLlama Q4_0's first layers; the
    ranks load the same file and keep as many) (module note, phase 3);
    returns the launches."""
    from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
    name = "serve_mesh_tiny"
    path = str(model_path("tinyllama-1.1b", "q4_0"))
    launches = {k: 0 for k in KERNELS}
    out = {}
    for tp, dp in ((2, 1), (1, 2)):
        res = world.run(serve_rank, path, model.cfg.n_layers, reqs, tp, dp, timeout=PAR_TIMEOUT)
        for k, n in rank_launches(f"{name} tp{tp} dp{dp}", res, PAR_KERNELS[name]).items():
            launches[k] += n
        require(all(r["outs"] == res[0]["outs"] for r in res),
                f"[{name}] tp{tp} dp{dp}: the ranks' streams differ")
        got = res[0]["outs"]
        ref = ContinuousBatchingEngine(model, max_batch=SERVE_BATCH // dp,
                                       prefill_chunk=SERVE_CHUNK)
        _, gaps = watch_server(torch, ref, gaps=tp > 1)
        ref_outs, _ = drive_server(ref, reqs)
        if tp == 1:
            # the same function a row at a time (each rank SERVE_BATCH // dp rows)
            n_cmp = [len(o) for o in got]
            require(got == ref_outs, f"[{name}] dp 2: streams differ from a one-process server "
                    f"of {SERVE_BATCH // dp} slots")
        else:
            n_cmp = [next((i for i, g in enumerate(gaps[rid]) if g < STEP_RTOL), len(o))
                     for rid, o in enumerate(got)]
            require(all(o[:c] == r[:c] for o, r, c in zip(got, ref_outs, n_cmp)),
                    f"[{name}] tp 2: tokens differ from the one-process server's before {n_cmp}")
            # and the same sharded server under force_ref() on the ranks: the
            # plain versions at the local shapes, up to their first small gap
            require(all(r["plain_outs"] == res[0]["plain_outs"] for r in res),
                    f"[{name}] tp 2: the ranks' plain streams differ")
            plain_outs = res[0]["plain_outs"]
            n_plain = [next((i for i, g in enumerate(pg) if g < STEP_RTOL), len(o))
                       for pg, o in zip(res[0]["plain_gaps"], got)]
            require(all(o[:c] == r[:c] for o, r, c in zip(got, plain_outs, n_plain)),
                    f"[{name}] tp 2: tokens differ from force_ref()'s on the same shards before "
                    f"{n_plain}: {got} vs {plain_outs}")
            log(f"  [{name}] tp 2 vs force_ref() on the same shards: streams equal over "
                f"{n_plain} (plain top-2 gap under {STEP_RTOL} of max|logit|), all equal "
                f"{got == plain_outs}")
        tokens = sum(len(o) for o in got)
        wall = max(r["wall_s"] for r in res)
        out[f"tp{tp}_dp{dp}"] = dict(
            outputs=got, tokens_checked=n_cmp, all_equal=got == ref_outs, steps=res[0]["steps"],
            **(dict(plain_tokens_checked=n_plain, plain_all_equal=got == plain_outs)
               if tp > 1 else {}),
            serve_tok_s=tokens / wall, wall_s=[r["wall_s"] for r in res],
            host_copies=[r["counters"].get("host_copies", 0) for r in res],
            placement=[r["tiers"] for r in res])
        log(f"  [{name}] tp {tp} x dp {dp}: {len(got)} requests in {res[0]['steps']} steps, "
            f"streams equal to the one-process server's (max_batch {SERVE_BATCH // dp}) over "
            f"{n_cmp}, all equal {got == ref_outs}; serving rate {tokens / wall:.1f} tok/s "
            f"(host wall {wall:.3f} s; ranks sharing one card over gloo); host copies per rank "
            f"{out[f'tp{tp}_dp{dp}']['host_copies']}  [{card}]")
    summary.setdefault("parallel", {})[name] = dict(launches=launches, card=card, **out)
    return launches


def train_par_path(torch, world, name, card, summary):
    """One training path of PAR_TRAIN over the two ranks (train_rank), held
    as the module note says; returns the launches."""
    res = world.run(train_rank, name, timeout=PAR_TIMEOUT)
    launches = rank_launches(name, res, PAR_TRAIN_KERNELS)
    for r, out in enumerate(res):
        lbl = f"{name} rank {r} {out['where']}"
        for got, want in zip(out["losses"], out["want_losses"]):
            require(np.isfinite(got) and abs(got - want) <= PAR_LOSS_RTOL * abs(want),
                    f"[{lbl}] losses {out['losses']} vs the one-process steps' "
                    f"{out['want_losses']} (bound {PAR_LOSS_RTOL:g} relative)")
        bad = [g for g in out["grads"] if not (g["finite"] and g["err"] <= g["bound"])]
        require(not bad, f"[{lbl}] gradients off the one-process ones: {bad[:4]}")
        worst = max(out["grads"], key=lambda g: g["err"] / max(g["bound"], 1e-30))
        log(f"  [{lbl}] losses {[round(v, 6) for v in out['losses']]} (one process "
            f"{[round(v, 6) for v in out['want_losses']]}); {len(out['grads'])} gradients, "
            f"worst against its bound: {worst['tensor']} err {worst['err']:.3g} bound "
            f"{worst['bound']:.3g} ({worst['err'] / max(worst['scale'], 1e-30):.3g} of max|g|); "
            f"first step {out['step_ms']:.1f} ms (host clock, ranks sharing one card); host "
            f"copies {out['counters'].get('host_copies', 0)} "
            f"({out['counters'].get('host_copy_bytes', 0)} bytes); placement {out['tiers']}  "
            f"[{card}]")
    same = set(res[0]["digests"]) == set(res[1]["digests"]) and all(
        res[1]["digests"][k] == v for k, v in res[0]["digests"].items())
    require(res[0]["digests"] and same, f"[{name}] the replicated leaves differ between the "
            f"ranks after {PAR_TRAIN_STEPS} steps")
    log(f"  [{name}] {len(res[0]['digests'])} replicated leaves the same bits on both ranks "
        f"after {PAR_TRAIN_STEPS} steps")
    summary.setdefault("parallel", {})[name] = dict(
        launches=launches, placement=[r["tiers"] for r in res],
        losses=[r["losses"] for r in res], one_process_losses=res[0]["want_losses"],
        grads=[r["grads"] for r in res], replicated_leaves=len(res[0]["digests"]),
        step_ms=[r["step_ms"] for r in res],
        host_copies=[r["counters"].get("host_copies", 0) for r in res],
        host_copy_bytes=[r["counters"].get("host_copy_bytes", 0) for r in res],
        where=[r["where"] for r in res], card=card, backend="gloo", ranks=PAR_RANKS)
    return launches


def pp_forward_path(torch, dev, world, prompts, card, summary):
    """pp2_tiny: make_pp_forward on the training paths' dense model over the
    two ranks (pp_forward_rank) at batch PP_FWD_BATCH, against the
    one-process model here on the same tokens: the prefill's last-position
    logits within LOGIT_RTOL * max, each decode step (fed the ranks' tokens)
    within STEP_RTOL * max, each row's tokens equal to the one-process greedy
    choice up to a top-2 gap under the prefill bound; both stages' logits the
    same bits; each stage ran its layers once a microbatch of each call and
    sat out pp - 1 bubble ticks. Returns the launches."""
    import dataclasses

    from zgml_tpu_torch.models.llama import LlamaModel, init_params
    from zgml_tpu_torch.parallel.pp import _choose_micro
    name = "pp2_tiny"
    prompts = np.stack(prompts)
    b, n_micro = prompts.shape[0], _choose_micro(prompts.shape[0], PAR_RANKS)
    require(n_micro > 1, f"[{name}] batch {b} gives one microbatch: the pipeline's "
            f"microbatched cache rows would not run")
    res = world.run(pp_forward_rank, prompts, PAR_NEW, timeout=PAR_TIMEOUT)
    launches = rank_launches(name, res, PP_FWD_KERNELS)
    layers = SHALLOW_LAYERS // PAR_RANKS
    for r, out in enumerate(res):
        want = layers * n_micro * (1 + PAR_NEW - 1)
        got = sum(out["tiers"].get(KERNELS[k][0], {}).get("cuda", 0) for k in PP_FWD_KERNELS)
        require(got == want, f"[{name} rank {r}] {got} attention launches, want {want} "
                f"({layers} layers a microbatch, {n_micro} microbatches a call)")
        ticks = [out["counters"].get(k, 0) for k in ("pp_stage_runs", "pp_bubble_ticks")]
        require(ticks == [n_micro * PAR_NEW, (PAR_RANKS - 1) * PAR_NEW],
                f"[{name} rank {r}] ticks run / bubble {ticks}, want "
                f"{[n_micro * PAR_NEW, (PAR_RANKS - 1) * PAR_NEW]}")
    require(all(np.array_equal(o["logits"], res[0]["logits"])
                and np.array_equal(o["steps"], res[0]["steps"]) for o in res),
            f"[{name}] the stages' logits differ")
    cfg = dataclasses.replace(preset("tinyllama-1.1b"), n_layers=SHALLOW_LAYERS)
    model = LlamaModel(cfg, init_params(cfg, seed=SEED, device=dev))
    out = res[0]
    with torch.inference_mode():
        cache = model.init_cache(b)
        want = model(torch.as_tensor(prompts, device=dev), cache, 0)[:, -1]
        fed = torch.as_tensor(np.asarray(out["tokens"]), device=dev)     # [B, PAR_NEW]
        steps = [model(fed[:, i:i + 1], cache, prompts.shape[1] + i)[:, -1]
                 for i in range(PAR_NEW - 1)]
    scale_p = float(want.abs().max())
    err_p = float(np.abs(out["logits"] - want.cpu().numpy()).max())
    require(err_p <= LOGIT_RTOL * scale_p, f"[{name}] prefill logits {err_p:.4g} from one "
            f"process's (bound {LOGIT_RTOL * scale_p:.4g})")
    errs = [float(np.abs(g - w.cpu().numpy()).max()) / float(w.abs().max())
            for g, w in zip(out["steps"], steps)]
    require(max(errs) <= STEP_RTOL, f"[{name}] decode steps {max(errs):.4g} of max|logit| from "
            f"one process's (bound {STEP_RTOL:g})")
    firsts = [want] + steps
    n_cmp = []
    for row in range(b):
        n = next((i for i, lg in enumerate(firsts) if top2_gap(lg[row]) < LOGIT_RTOL * scale_p),
                 PAR_NEW)
        ref_toks = [int(torch.argmax(lg[row])) for lg in firsts]
        require(out["tokens"][row][:n] == ref_toks[:n],
                f"[{name}] row {row}'s tokens differ before step {n}: {out['tokens'][row]} vs "
                f"{ref_toks}")
        n_cmp.append(n)
    del model, cache
    torch.cuda.empty_cache()
    pp = [b * PAR_PROMPT / o["pp_s"] for o in res]
    tg = [b * (PAR_NEW - 1) / o["tg_s"] for o in res]
    log(f"  [{name}] pp 2 over 2 gloo ranks, batch {b} in {n_micro} microbatches: prefill "
        f"logits {err_p:.4g} from one process's ({err_p / scale_p:.3g} of max|logit|), decode "
        f"steps up to {max(errs):.3g} of max|logit|, tokens equal over the first {n_cmp} of "
        f"{PAR_NEW}; pp{PAR_PROMPT} {min(pp):.1f} tok/s, tg{PAR_NEW} {min(tg):.1f} tok/s over the "
        f"batch (host clock, ranks sharing one card); ticks "
        f"{[o['counters'].get('pp_stage_runs', 0) for o in res]} run, "
        f"{[o['counters'].get('pp_bubble_ticks', 0) for o in res]} bubble; host copies "
        f"{[o['counters'].get('host_copies', 0) for o in res]}; placement {res[0]['tiers']}  "
        f"[{card}]")
    summary.setdefault("parallel", {})[name] = dict(
        launches=launches, placement=[o["tiers"] for o in res], logits_err=err_p,
        logits_scale=scale_p, step_errs=errs, tokens=out["tokens"], tokens_checked=n_cmp,
        batch=b, n_micro=n_micro, pp_tok_s=pp, tg_tok_s=tg,
        host_copies=[o["counters"].get("host_copies", 0) for o in res],
        ticks=[{k: o["counters"].get(k, 0) for k in ("pp_stage_runs", "pp_bubble_ticks")}
               for o in res], card=card, backend="gloo", ranks=PAR_RANKS)
    return launches


def nccl_check(torch, dev, summary):
    """NCCL in this process at world size 1: init_distributed, then
    all_reduce and all_gather through parallel/mesh.py, equal to their
    input; the group is left before the function returns."""
    import tempfile

    import torch.distributed as dist
    from zgml_tpu_torch.parallel import init_distributed, make_mesh
    from zgml_tpu_torch.parallel.mesh import all_gather, all_reduce
    with tempfile.TemporaryDirectory() as tmp:
        got_dev = init_distributed("nccl", pathlib.Path(tmp, "rdv").as_uri(), 0, 1)
        try:
            mesh = make_mesh(device=dev)
            x = torch.arange(1024, dtype=torch.float32, device=dev)
            red = all_reduce(x, mesh.groups["tp"])
            gat = all_gather(x, mesh.groups["tp"])
            torch.cuda.synchronize()
            ok = (bool(torch.equal(red, x)) and bool(torch.equal(gat, x))
                  and dist.get_backend() == "nccl")
        finally:
            dist.destroy_process_group()
    require(ok, "NCCL at world size 1: all_reduce / all_gather do not return their input")
    log(f"  [nccl] world size 1 on {got_dev}: init, all_reduce and all_gather of 1024 floats "
        f"equal their input (backend nccl)")
    summary.setdefault("parallel", {})["nccl"] = dict(ok=ok, device=str(got_dev))


def parallel_paths(torch, dev, models, shallow, prompts, serve_reqs, card, summary):
    """Phase 3's parallel paths on PAR_RANKS spawned ranks that share the
    card over gloo (one World for all, each run bounded by PAR_TIMEOUT: a
    rank that fails or hangs fails the smoke; serve_mesh_tiny on `shallow`,
    the TinyLlama Q4_0 model's first SHALLOW_LAYERS layers), then NCCL at
    world size 1 in this process. Returns {path: launches}."""
    from zgml_tpu_torch.parallel.world import World
    set_path("default")
    launches = {}
    t0 = time.perf_counter()
    with World(PAR_RANKS, backend="gloo", device="cuda") as world:
        log(f"  {PAR_RANKS} gloo ranks up in {time.perf_counter() - t0:.1f} s on "
            f"{world.devices}")
        t1 = time.perf_counter()
        launches["tp2_7b"] = tp2_path(torch, world, models["llama2-7b", "q4_0"],
                                      prompts[1][:PAR_PROMPT], card, summary)
        t2 = time.perf_counter()
        launches["cp2_tiny"] = cp2_path(torch, world, models["tinyllama-1.1b", "q4_0"],
                                        prompts[3], card, summary)
        t3 = time.perf_counter()
        launches["serve_mesh_tiny"] = serve_mesh_path(torch, world, shallow, serve_reqs, card,
                                                      summary)
        t4 = time.perf_counter()
        train_s = {}
        for name in PAR_TRAIN:
            t5 = time.perf_counter()
            launches[name] = train_par_path(torch, world, name, card, summary)
            train_s[name] = time.perf_counter() - t5
        t5 = time.perf_counter()
        launches["pp2_tiny"] = pp_forward_path(
            torch, dev, world, [p[:PAR_PROMPT] for p in prompts[1:1 + PP_FWD_BATCH]], card,
            summary)
        train_s["pp2_tiny"] = time.perf_counter() - t5
    nccl_check(torch, dev, summary)
    summary["parallel_s"] = dict(tp2_7b=t2 - t1, cp2_tiny=t3 - t2, serve_mesh_tiny=t4 - t3,
                                 **train_s, total=time.perf_counter() - t0)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here", file=sys.stderr)
        return 2
    from zgml_tpu_torch.ops import build

    dev = torch.device("cuda")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "log.txt").write_text("")
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
    if (path.parent / "build.log").is_file():    # ptxas -v of the tensor-core kernels
        for key, pattern in (("ptxas_flash", "flash"), ("ptxas_qmatmul_bwd", "qgemm_bwd"),
                             ("ptxas_qmatmul", "qgemm_tf32"),
                             ("ptxas_qmatmul_bf16", "qgemm_bf16"), ("ptxas_rmsnorm", "rmsnorm"),
                             ("ptxas_chain", "chain_kernel"), ("ptxas_attn", "layer_attn_kernel"),
                             ("ptxas_ffn", "ffn_norm_kernel"),
                             ("ptxas_stack", "stack_decode_kernel"),
                             ("ptxas_planar", "ffn_planar"),
                             ("ptxas_decode", "decode_kv_kernel"),
                             ("ptxas_decode_q8", "decode_q8_kernel"),
                             ("ptxas_i8", "qi8_kernel")):
            summary[key] = ptxas_report(path.parent / "build.log", pattern)
            for e in summary[key]:
                log(f"  ptxas {e['entry'][:70]}: {e.get('registers')} registers, "
                    f"{e.get('spill_stores')} bytes spill stores, {e.get('stack')} bytes stack")
        spilled = [e["entry"] for e in summary["ptxas_qmatmul_bwd"] if e.get("spill_stores")]
        require(not spilled, f"K11 spills registers: {spilled}")
        spilled = [e["entry"] for e in summary["ptxas_qmatmul"] + summary["ptxas_qmatmul_bf16"]
                   if e.get("spill_stores")]
        require(summary["ptxas_qmatmul_bf16"] and not spilled,
                f"K2's tiled tier (or its bf16 GEMM) spills registers: {spilled}")
        spilled = [e["entry"] for e in summary["ptxas_flash"]
                   if ("flash_d" in e["entry"] or "flash_bf16" in e["entry"])
                   and e.get("spill_stores")]
        require(not spilled, f"K10dq / K10dkv or the bf16 flash forward spill registers: "
                f"{spilled}")
        spilled = [e["entry"] for e in summary["ptxas_rmsnorm"] + summary["ptxas_chain"]
                   if e.get("spill_stores")]
        require(not spilled, f"K12 / K13 spill registers: {spilled}")
        # K7 and K6 at one row (the decode calls; ffn_norm_kernel<F, 1, ...>)
        # and K14 / K15: no spill and no stack frame (the producer's gate in
        # local memory cost the megacalls 1-3%); K6's groups of 2 and 4 rows
        # are recorded
        spilled = [e["entry"] for e in summary["ptxas_attn"] + summary["ptxas_ffn"]
                   if ("layer_attn" in e["entry"] or "Li1E" in e["entry"])
                   and (e.get("spill_stores") or e.get("stack"))]
        require(not spilled, f"K7 / K6 at one row spill registers or use a stack frame: "
                f"{spilled}")
        spilled = [e["entry"] for e in summary["ptxas_stack"]
                   if e.get("spill_stores") or e.get("stack")]
        require(summary["ptxas_stack"] and not spilled,
                f"K14 / K15 spill registers or use a stack frame (or no ptxas report): "
                f"{spilled}")
        # K6b's tensor-core form, its CUDA-core form at 1 and 2 rows a group
        # (ffn_planar_f32_kernel<1>, <2>), K4 and K8: no spill; the CUDA-core form
        # at 4 rows is K6d's MR 4 dot at the 96-register cap and is recorded,
        # as K6d's MR 4 is
        spilled = [e["entry"] for e in summary["ptxas_planar"] + summary["ptxas_decode"]
                   + summary["ptxas_decode_q8"]
                   if e.get("spill_stores") and "f32_kernelILi4E" not in e["entry"]]
        require(summary["ptxas_planar"] and summary["ptxas_decode"]
                and summary["ptxas_decode_q8"] and not spilled,
                f"K6b / K4 / K8 spill registers (or no ptxas report): {spilled}")
        # K1 / K5 (every instantiation): no spill and no stack frame
        spilled = [e["entry"] for e in summary["ptxas_i8"]
                   if e.get("spill_stores") or e.get("stack")]
        require(summary["ptxas_i8"] and not spilled,
                f"K1 / K5 spill registers or use a stack frame (or no ptxas report): {spilled}")

    writer = multiprocessing.get_context("spawn").Process(target=write_ggufs, daemon=True)
    writer.start()

    log("== 2. kernels vs plain torch on the card (TinyLlama-1.1B shapes at Q4_0 and Q8_0, "
        "Llama-2-7B shapes)")
    t0 = time.perf_counter()
    checks = check_kernels(torch, dev, summary.get("ptxas_decode_q8", []))
    summary["ffn_vjp"] = checks.pop("_ffn_vjp")
    log(f"  phase 2 took {time.perf_counter() - t0:.1f} s")

    log("== 3. end to end: TinyLlama-1.1B, the default and unfused paths at Q4_0, the "
        "default path at Q8_0; Llama-2-7B at Q4_0, the default path; both with the int8 KV "
        "cache; TinyLlama-1.1B Q4_0 under ZGML_TPU_KERNELS_FORCE=rmsnorm and through the "
        "megacalls K14 and K15; training; the graph tier")
    t0 = time.perf_counter()
    writer.join(GGUF_TIMEOUT)
    if writer.is_alive():
        writer.kill()
        writer.join()
    require(writer.exitcode == 0, f"writing the GGUFs failed or took over {GGUF_TIMEOUT} s "
            f"(exit code {writer.exitcode})")
    log(f"  the GGUF writer joined {time.perf_counter() - t0:.1f} s after phase 2")
    models = {m: load_model(torch, dev, *m) for m in dict.fromkeys(PATH_MODEL.values())}
    # the megacall views on the model every TinyLlama Q4_0 path shares: only
    # stack_tiny's and tape_tiny's flags may make decode take them
    tiny = models["tinyllama-1.1b", "q4_0"]
    require(tiny.enable_stacked_decode() and tiny.enable_tape_decode(),
            "TinyLlama-1.1B Q4_0: enable_stacked_decode / enable_tape_decode refused")
    shallow = {m: shallow_model(models[m], SHALLOW_LAYERS)
               for m in (("tinyllama-1.1b", "q4_0"), ("tinyllama-1.1b", "q8_0"),
                         ("llama2-7b", "q4_0"))}
    require(shallow["tinyllama-1.1b", "q4_0"].enable_stacked_decode()
            and shallow["tinyllama-1.1b", "q4_0"].enable_tape_decode(),
            f"the {SHALLOW_LAYERS}-layer TinyLlama: enable_stacked_decode / enable_tape_decode "
            f"refused")
    rng = np.random.default_rng(SEED)
    vocab = min(m.cfg.vocab_size for m in models.values())
    # the three greedy prompts, the long prompt, the batch-4 prompts
    prompts = [rng.integers(0, vocab, n) for n in (7, 128, 300, LONG_PROMPT)]
    prompts.append({n: rng.integers(0, vocab, (4, n))
                    for n in sorted(set(BATCH4_PATHS.values()))})
    engines, engines4, launches = {}, {}, {}
    for name in PATHS:
        model = (shallow if name in SHALLOW_PATHS else models)[PATH_MODEL[name]]
        engines[name], launches[name], eng4 = end_to_end(torch, model, prompts, name, summary)
        if eng4 is not None:
            engines4[name] = eng4
    launches[F32KV_TINY_F32[0]] = f32_prefill_check(torch, engines["f32kv_tiny"], prompts[1],
                                                   summary)
    for name, (label, _) in MEGA_F32_PATHS.items():
        launches[label] = megacall_f32_request(
            torch, (shallow if name in SHALLOW_PATHS else models)[PATH_MODEL[name]], prompts[0],
            name, summary)
    kernel_switch_check(torch, tiny, prompts[1], summary)
    log(f"  phase 3 (inference) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_reqs = serve_traffic(tiny.cfg.vocab_size)
    for name in SERVE_PATHS:
        launches[name] = serving_path(
            torch, shallow["tinyllama-1.1b", "q4_0"] if name in SHALLOW_PATHS else tiny,
            serve_reqs, name, summary)
    log(f"  phase 3 (serving) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trainers = train_paths(torch, dev, models, summary, launches)
    log(f"  phase 3 (training) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["graph_ffn"], graph, graph_feeds = graph_ffn_path(torch, dev, summary)
    launches["graph_ffn_bf16"], graph16, graph16_feeds = graph_ffn_bf16_path(torch, dev, summary)
    launches["graph_sub"] = graph_sub_path(torch, dev, summary)
    log(f"  phase 3 (graph tier) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(weight_form_paths(torch, dev, models, prompts[0], summary))
    log(f"  phase 3 (weight forms, text and quality) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["gpt2_xl"], launches["gpt2_xl_f32"] = gpt2_path(torch, dev, card, summary)
    t1 = time.perf_counter()
    launches["whisper_large_v3"] = whisper_path(torch, dev, card, summary)
    summary["model_paths_s"] = dict(gpt2_xl=t1 - t0, whisper_large_v3=time.perf_counter() - t1)
    log(f"  phase 3 (GPT-2 XL, Whisper large-v3) took {time.perf_counter() - t0:.1f} s "
        f"(gpt2_xl {t1 - t0:.1f} s, file writes included)")
    t0 = time.perf_counter()
    launches.update(parallel_paths(torch, dev, models, shallow["tinyllama-1.1b", "q4_0"],
                                   prompts, serve_reqs, card, summary))
    log(f"  phase 3 (parallel: tp2_7b, cp2_tiny, serve_mesh_tiny, nccl) took "
        f"{time.perf_counter() - t0:.1f} s")

    log("== 4. rates (the paths in turns) and where the time goes")
    t0 = time.perf_counter()
    rates(torch, engines, prompts[2], prompts[3], card, summary)
    batch4_rates(torch, engines4, prompts[4][max(BATCH4_PATHS.values())], card, summary)
    for name, eng in engines.items():
        set_path(name)
        profile(torch, eng, prompts[2], prompts[3], name, summary)
    set_path("default")
    serving_rates(torch, tiny, serve_reqs, card, summary)
    train_rates(torch, trainers, card, summary)
    for name, tr in trainers.items():
        train_profile(torch, lambda t_=tr: t_.step(0), name, summary)
    graph_rates(torch, graph, graph_feeds, card, summary)
    graph_rates(torch, graph16, graph16_feeds, card, summary, "graph_ffn_bf16")
    for name in ("tp2_7b", "cp2_tiny", "serve_mesh_tiny"):      # timed in phase 3
        par = summary["parallel"][name]
        rate = {k: par[k] for k in ("pp_tok_s", "tg_tok_s") if k in par} or {
            k: v["serve_tok_s"] for k, v in par.items()
            if isinstance(v, dict) and "serve_tok_s" in v}
        used = {k: n for k, n in launches[name].items() if n}
        log(f"  [{name}] launches over both ranks {used}; rates (host clock, ranks sharing one "
            f"card, phase 3) {rate}  [{card}]")
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")

    log("== 5. modules: the native host codecs, the packed checkpoint, the roofline, the "
        "conformance sweep")
    t0 = time.perf_counter()
    modules_phase(torch, dev, models, card, summary)
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")

    kernels = [kernel_line(name, checks[name], {p: n[name] for p, n in launches.items()})
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
