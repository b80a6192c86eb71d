"""Inference engine: chunked prefill, then greedy or sampled decode.

Counterpart of zgml_tpu/runtime/engine.py (prefill 103-126, step, decode_n
69-91, generate 242-266, reset). PyTorch runs eagerly, so there are no
compiled plans: prefill runs `prefill_chunk`-token windows, the last one
zero-padded to the chunk with attention over kv_len = pos + chunk exactly as
the JAX engine does (the padded rows' K/V land in the cache past the valid
prefix and are overwritten by the next tokens); decode_n is a Python loop
whose tokens stay on the device, so a burst needs no host sync until its ids
are read. The KV cache is updated in place; `cache_dtype` "int8" makes it
the int8 cache (engine.py:33, 41), whose prefill runs K9 and decode K7's
int8-cache mode at batch 1, K8 above; "f32" the f32 one (the JAX engine's
cache_dtype=jnp.float32), whose prefill runs K3's f32-K/V forms and decode
K7's f32-cache mode at batch 1, K4's f32 form above.

The tiers match the JAX engine's plans (engine.py:46-91): `step` and sampled
`decode_n` take the logits through the M = B projection (K1 when the int8
tier is on), greedy `decode_n` the fused greedy head (K5), and batch-1 decode
runs the layer kernels (K7, K6) when ZGML_TPU_ATTN_BLOCK is on.

`prefill_cp` is the context-parallel prefill (engine.py:128-206) over a
mesh axis of parallel/mesh.py; an engine over a tensor-parallel shard
(parallel/tp.shard_llama_params) runs its usual calls on every rank of the
tp group together.
"""
from __future__ import annotations

import numpy as np
import torch

from zgml_tpu_torch.models.llama import LlamaModel, write_kv
from zgml_tpu_torch.parallel.cp import cp_prefill
from zgml_tpu_torch.parallel.mesh import broadcast
from zgml_tpu_torch.quant import kv_cache
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.sampling import SamplingParams, sample


class LlamaEngine:
    """One model, one KV cache of `batch` rows, one position."""

    def __init__(self, model: LlamaModel, batch: int = 1, prefill_chunk: int = 128,
                 cache_dtype: str = "bf16", sampling: SamplingParams = SamplingParams()):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.prefill_chunk = min(prefill_chunk, model.cfg.max_seq_len)
        self.sampling = sampling
        self.device = model.device
        self.cache = model.init_cache(batch, cache_dtype)
        self.pos = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def reset(self):
        """Rewind to position 0. Cache entries past kv_len are never read, so
        nothing is cleared."""
        self.pos = 0

    def _ids(self, tokens, shape) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.int64).reshape(shape)
        return torch.as_tensor(np.asarray(tokens, np.int64).reshape(shape), device=self.device)

    @torch.inference_mode()
    def prefill(self, tokens) -> torch.Tensor:
        """Run a prompt ([T] for batch 1, or [B, T]); returns the last valid
        position's logits f32 [B, V]."""
        tokens = np.atleast_2d(np.asarray(tokens, np.int64))
        b, t = tokens.shape
        if b != self.batch:
            raise ValueError(f"engine holds batch {self.batch}, got {b}")
        if t == 0:
            raise ValueError("empty prompt")
        if self.pos + t > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        last = None
        with global_profile.phase("prefill"):
            for i in range(0, t, self.prefill_chunk):
                window = tokens[:, i:i + self.prefill_chunk]
                n_valid = window.shape[1]
                # the padded tail fills the chunk unless the cache ends first
                size = min(self.prefill_chunk, self.cfg.max_seq_len - self.pos)
                if n_valid < size:
                    window = np.pad(window, ((0, 0), (0, size - n_valid)))
                x = self.model.body(self._ids(window, window.shape), self.cache, self.pos)
                # the JAX engine computes the head over the whole chunk
                # (engine.py:53-58), so its tier follows the chunk's rows
                last = self.model.head(x[:, n_valid - 1:n_valid],
                                       tier_rows=window.size)[:, 0]
                self.pos += n_valid
        global_profile.add("prefill_tokens", t * b)
        return last

    @torch.inference_mode()
    def prefill_cp(self, tokens, mesh, axis: str = "cp") -> torch.Tensor:
        """Context-parallel prefill of a prompt from a fresh session over the
        mesh axis `axis` (engine.py:128-206): every rank of the axis group
        calls it with the same prompt and its own engine over the whole
        model. The prompt is zero-padded to a multiple of cp, each rank runs
        its chunk through parallel/cp.cp_prefill (ring attention), and the
        gathered K/V of the t real positions land in this engine's cache: the
        bf16 cache takes them rounded, the f32 one as they are, the int8 one
        quantized per position
        (quant/kv_cache.write, bit-equal to quantize_columns). Sets pos = t
        and returns the last real row's logits f32 [B, V] (computed by the
        rank whose chunk holds it, at the tier of its chunk's rows, and
        broadcast). Decode then continues on the normal path."""
        tokens = np.atleast_2d(np.asarray(tokens, np.int64))
        b, t = tokens.shape
        if b != self.batch:
            raise ValueError(f"engine holds batch {self.batch}, got {b}")
        if self.pos != 0:
            raise ValueError("prefill_cp requires a fresh session (pos==0)")
        if t > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        cp, idx, group = mesh.shape[axis], mesh.coords[axis], mesh.groups[axis]
        t_loc = -(-t // cp)
        toks = np.pad(tokens, ((0, 0), (0, t_loc * cp - t)))
        with global_profile.phase("prefill_cp"):
            x, kv = cp_prefill(self.model, group, self._ids(toks[:, idx * t_loc:(idx + 1) * t_loc],
                                                             (b, t_loc)))
            int8 = "k_s" in self.cache
            for li, (k, v) in enumerate(kv):
                k, v = k[:, :, :t], v[:, :, :t]
                if int8:
                    kv_cache.write((self.cache["k"], self.cache["k_s"]),
                                   (self.cache["v"], self.cache["v_s"]), li, 0, k, v)
                else:
                    write_kv(self.cache["k"], self.cache["v"], li, 0, k, v)
            owner, row = divmod(t - 1, t_loc)
            last = torch.empty((b, self.cfg.vocab_size), dtype=torch.float32,
                               device=self.device)
            if idx == owner:
                last = self.model.head(x[:, row:row + 1], tier_rows=b * t_loc)[:, 0]
            last = broadcast(last, group, owner)
        self.pos = t
        global_profile.add("prefill_tokens", t * b)
        return last

    @torch.inference_mode()
    def step(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """One decode step from the last ids [B]; returns (next ids [B],
        logits [B, V])."""
        if self.pos + 1 > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        tok = self._ids(tokens, (self.batch, 1))
        with global_profile.phase("decode"):
            logits = self.model(tok, self.cache, self.pos)[:, -1]
            nxt = sample(logits, self.sampling, self.generator)
        self.pos += 1
        global_profile.add("decode_tokens", self.batch)
        return nxt, logits

    @torch.inference_mode()
    def decode_n(self, tokens, n_steps: int) -> torch.Tensor:
        """Generate n_steps tokens after the ids [B]; returns ids [n_steps, B]
        on the device. Same positions as n_steps calls of `step`."""
        if self.pos + n_steps > self.cfg.max_seq_len:
            raise ValueError("SequenceTooLong")
        tok = self._ids(tokens, (self.batch,))
        greedy = self.sampling.temperature == 0.0
        out = []
        with global_profile.phase("decode_n"):
            for _ in range(n_steps):
                if greedy:
                    tok = self.model(tok[:, None], self.cache, self.pos, greedy_head=True)
                else:
                    logits = self.model(tok[:, None], self.cache, self.pos)[:, -1]
                    tok = sample(logits, self.sampling, self.generator)
                out.append(tok)
                self.pos += 1
        global_profile.add("decode_tokens", n_steps * self.batch)
        return torch.stack(out)

    def generate(self, prompt, max_new_tokens: int, stop_ids: tuple[int, ...] = (),
                 burst: int = 32) -> list[int]:
        """Batch-1 generation: prefill, then decode in `burst`-token runs of
        decode_n, cut at the first stop id."""
        last_logits = self.prefill(prompt)
        tok = sample(last_logits, self.sampling, self.generator)
        out = [int(tok[0])]
        while len(out) < max_new_tokens and out[-1] not in stop_ids:
            n = min(burst, max_new_tokens - len(out))
            if n == 1 or self.pos + n > self.cfg.max_seq_len:
                tok, _ = self.step(tok)
                out.append(int(tok[0]))
                continue
            toks = self.decode_n(tok, n)
            for t in toks[:, 0].tolist():
                out.append(t)
                if t in stop_ids:
                    break
            tok = toks[-1]
        return out
