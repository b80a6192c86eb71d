"""Continuous batching: many requests at different positions in one decode.

Counterpart of zgml_tpu/runtime/serving.py (single host). `max_batch` slots
share one KV cache of `max_batch` rows and one batched decode step with
per-row positions (`LlamaModel.forward(tokens, cache, pos_vec,
write_pos=...)`: RoPE and kv_len per row, each row's K/V written at its own
position, indexed on the device). A request joins between decode steps:
`step` admits waiting requests to free slots and advances at most one
prefill chunk of one of them, written straight into its slot's rows of the
shared cache (`forward(..., cache_row=slot)`: flash attention through
kv_row), so decoding slots never stall behind a long prompt; a request
leaves when it has its tokens, meets a stop id or fills the cache.

Inactive and mid-prefill slots decode at position 0 with their K/V written
at the dead position max_seq_len - 1, which no live request reaches
(requests finish at pos + 1 >= max_seq_len), and their tokens are ignored.
`step_burst(n)` runs n decode steps with the tokens and positions advanced
on the device and reads the [n, B] ids once at the end; overshoot past a
stop id or a token budget is cut on the host (the overshot K/V is never
read: the slot's next occupant prefills from position 0). The JAX burst is
one lax.scan dispatch; here it is a Python loop whose tensors stay on the
device (a CUDA graph of it is ROADMAP.md A.2's work).

Sampling draws from a torch.Generator on the model's device seeded from
`seed` (JAX keys and torch generators give different streams: greedy
decoding is what the two packages share). Over a mesh every rank draws for
all max_batch rows, so a sampled stream is the one-process server's.

One repair against the reference: a padded last chunk that would run past
max_seq_len (only where prefill_chunk does not divide it) is trimmed to
max_seq_len - pos, as LlamaEngine.prefill trims it; the JAX engine pads it
to the whole chunk, its dynamic_update_slice clamps the start, and the cache
is corrupted (ROADMAP.md, reference weak spots).

Over a (dp, tp) mesh (`mesh=`, parallel/mesh.py; serving.py:56-215) every
rank runs this engine with the same calls. The slots are sharded over dp:
dp rank i owns slots [i * b, (i + 1) * b), b = max_batch / dp, in a cache of
b rows (its local KV heads under tp, the model sharded by
parallel/tp.shard_llama_params). A slot's prefill chunk runs only in its
owner's tp group, and its logits are broadcast over dp; a decode step or a
burst runs on every rank over its own rows, and the sampled ids are
gathered over dp, so every rank's host state (admission, positions,
streams) stays identical. A process per rank needs no scratch row: JAX's
non-owner shards write into one (serving.py:154-163).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np
import torch

from zgml_tpu_torch.models.llama import LlamaModel
from zgml_tpu_torch.parallel.mesh import all_gather, broadcast
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.sampling import SamplingParams, sample


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int
    stop_ids: tuple[int, ...] = ()
    rid: int = -1
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Prefill:
    """A request whose prompt is being prefilled chunk by chunk into its
    reserved slot (interleaved with decode steps)."""
    req: Request
    slot: int
    pos: int = 0                 # prompt tokens written so far


class ContinuousBatchingEngine:
    """`max_batch` slots over one model and one shared KV cache ("bf16",
    "f32" or "int8"), on the model's device (the card unless the model was built with
    device="cpu"); with `mesh`, this rank's share of them (module note)."""

    def __init__(self, model: LlamaModel, max_batch: int = 8, prefill_chunk: int = 128,
                 cache_dtype: str = "bf16", sampling: SamplingParams = SamplingParams(),
                 seed: int = 0, mesh=None):
        self.mesh = mesh
        self.dp = 1 if mesh is None else mesh.shape.get("dp", 1)
        tp = 1 if mesh is None else mesh.shape.get("tp", 1)
        sharded = model.tp.size if model.tp else 1
        if max_batch % self.dp:
            raise ValueError(f"max_batch={max_batch} not divisible by dp={self.dp}")
        if sharded != tp:
            raise ValueError(f"the model is sharded {sharded} ways, the mesh's tp is {tp}: run "
                             f"shard_llama_params(model, mesh)")
        self._b_loc = max_batch // self.dp          # this rank's rows
        self._dpi = 0 if mesh is None else mesh.coords.get("dp", 0)
        self._rows = slice(self._dpi * self._b_loc, (self._dpi + 1) * self._b_loc)
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.sampling = sampling
        self.device = model.device
        self.cache = model.init_cache(self._b_loc, cache_dtype)
        self.prefill_chunk = min(prefill_chunk, self.cfg.max_seq_len)
        self.pos = np.zeros(max_batch, np.int64)
        self.slots: list[Request | None] = [None] * max_batch
        self.last_tok = np.zeros(max_batch, np.int64)
        self.waiting: deque[Request] = deque()
        self.requests: dict[int, Request] = {}   # rid -> request
        self.prefilling: deque[_Prefill] = deque()
        self._ids = itertools.count()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._dead_pos = self.cfg.max_seq_len - 1   # a position no live request reaches

    # -- the device steps ------------------------------------------------------
    def _prefill_slot(self, tokens: np.ndarray, slot: int, pos: int, n_valid: int
                      ) -> torch.Tensor:
        """One prefill chunk [1, T] written into slot `slot`'s rows at pos;
        the logits f32 [1, V] of its last valid token (the head's tier that
        of the whole chunk, as JAX computes the chunk's logits). Over a mesh
        only the slot's owner dp group computes, and broadcasts them."""
        owner, row = divmod(slot, self._b_loc)
        if owner == self._dpi:
            ids = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
            x = self.model.body(ids, self.cache, pos, cache_row=row)
            last = self.model.head(x[:, n_valid - 1:n_valid], tier_rows=tokens.size)[:, 0]
        else:
            last = torch.empty((1, self.cfg.vocab_size), dtype=torch.float32,
                               device=self.device)
        if self.dp > 1:
            last = broadcast(last, self.mesh.groups["dp"], owner)
        return last

    def _gathered(self, tok: torch.Tensor) -> torch.Tensor:
        """This rank's ids [..., b] joined over dp into [..., max_batch]."""
        return tok if self.dp == 1 else all_gather(tok, self.mesh.groups["dp"], dim=-1)

    def _device_state(self, active: list[int]) -> tuple[torch.Tensor, torch.Tensor,
                                                        torch.Tensor]:
        """(last ids [b], positions int32 [b], active mask [b]) of this
        rank's rows on the device."""
        mask = np.zeros(self.max_batch, bool)
        mask[active] = True
        rows = self._rows
        return (torch.as_tensor(self.last_tok[rows], device=self.device),
                torch.as_tensor(self.pos[rows].astype(np.int32), device=self.device),
                torch.as_tensor(mask[rows], device=self.device))

    def _decode_logits(self, tok: torch.Tensor, pos: torch.Tensor, active: torch.Tensor
                       ) -> torch.Tensor:
        """One batched decode step's logits [B, V]. Inactive and mid-prefill
        slots write their K/V at the dead position."""
        wpos = torch.where(active, pos, torch.full_like(pos, self._dead_pos))
        return self.model(tok[:, None], self.cache, pos, write_pos=wpos)[:, -1]

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor, active: torch.Tensor
                ) -> torch.Tensor:
        """One batched decode step: this rank's next ids [b] on the device.
        Sampling over dp gathers the logits of all max_batch rows and draws
        for every row on every rank (one generator, seeded alike), keeping
        this rank's: the draws of the one-process server, as the JAX mesh
        server samples the global batch, so no two dp ranks' rows share
        random numbers."""
        logits = self._decode_logits(tok, pos, active)
        if self.dp > 1 and self.sampling.temperature != 0.0:
            logits = all_gather(logits, self.mesh.groups["dp"], dim=0)
            return sample(logits, self.sampling, self.generator)[self._rows]
        return sample(logits, self.sampling, self.generator)

    # -- public api ------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, stop_ids: tuple[int, ...] = ()) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        # a prompt longer than the cache cannot be written; reject it as
        # LlamaEngine.prefill does (serving.py:206-220)
        if len(prompt) + 1 > self.cfg.max_seq_len:
            raise ValueError(f"SequenceTooLong: prompt {len(prompt)} + 1 exceeds "
                             f"max_seq_len {self.cfg.max_seq_len}")
        req = Request(prompt, max_new_tokens, tuple(stop_ids), rid=next(self._ids))
        self.waiting.append(req)
        self.requests[req.rid] = req
        return req.rid

    def _admit(self):
        """Reserve free slots for waiting requests (their prompts are
        prefilled chunk by chunk in _advance_prefill)."""
        reserved = {p.slot for p in self.prefilling}
        while self.waiting:
            slot = next((i for i, s in enumerate(self.slots)
                         if s is None and i not in reserved), None)
            if slot is None:
                return
            req = self.waiting.popleft()
            self.prefilling.append(_Prefill(req, slot))
            reserved.add(slot)

    def _advance_prefill(self, max_chunks: int = 1):
        """Advance pending prefills by up to `max_chunks` chunks in all: the
        admission work done between two decode steps. The last chunk is
        zero-padded to the chunk, or to the cache's end where that comes
        first, and its logits are taken at its last valid token."""
        chunk = self.prefill_chunk
        for _ in range(max_chunks):
            if not self.prefilling:
                return
            p = self.prefilling[0]
            toks = np.asarray(p.req.prompt, np.int64)[None, p.pos:p.pos + chunk]
            n_valid = toks.shape[1]
            size = min(chunk, self.cfg.max_seq_len - p.pos)
            if n_valid < size:
                toks = np.pad(toks, ((0, 0), (0, size - n_valid)))
            with torch.inference_mode(), global_profile.phase("serve_prefill"):
                last = self._prefill_slot(toks, p.slot, p.pos, n_valid)
            p.pos += n_valid
            if p.pos >= len(p.req.prompt):          # prefill complete
                self.prefilling.popleft()
                first = sample(last, self.sampling, self.generator)
                p.req.output.append(int(first[0]))
                self.slots[p.slot] = p.req
                self.pos[p.slot] = p.pos
                self.last_tok[p.slot] = p.req.output[-1]
                self._maybe_finish(p.slot)

    def _maybe_finish(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        if (len(req.output) >= req.max_new_tokens
                or (req.output and req.output[-1] in req.stop_ids)
                or self.pos[slot] + 1 >= self.cfg.max_seq_len):
            req.done = True
            self.slots[slot] = None
            self.pos[slot] = 0

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def step(self) -> list[tuple[int, int]]:
        """Admit, one prefill chunk, one batched decode step; returns the
        (rid, token) emissions of the decode step."""
        self._admit()
        self._advance_prefill()
        active = self._active()
        if not active:
            return []
        with torch.inference_mode(), global_profile.phase("serve_decode"):
            tok = self._gathered(self._decode(*self._device_state(active)))
        tok_host = tok.cpu().numpy()
        out = []
        for i in active:
            req = self.slots[i]
            t = int(tok_host[i])
            req.output.append(t)
            self.pos[i] += 1
            self.last_tok[i] = t
            out.append((req.rid, t))
            self._maybe_finish(i)
        global_profile.add("serve_decode_tokens", len(active))
        return out

    def step_burst(self, n: int) -> list[tuple[int, int]]:
        """Like step, but n decode steps with the ids and positions advanced
        on the device and one host read of the [n, B] ids. Only when no
        admission is pending (else one step); n is cut to every active
        slot's token budget and room, then to a power of two (the JAX
        engine's compile buckets, kept so the emissions equal its own)."""
        self._admit()
        self._advance_prefill()
        if self.prefilling or self.waiting:
            return self.step()                  # interleave stepwise
        active = self._active()
        if not active:
            return []
        n = min(n, *(self.slots[i].max_new_tokens - len(self.slots[i].output) for i in active),
                int(self.cfg.max_seq_len - 1 - max(self.pos[i] for i in active)))
        if n < 1:
            return self.step()
        n = 1 << (n.bit_length() - 1)
        with torch.inference_mode(), global_profile.phase("serve_decode"):
            tok, pos, mask = self._device_state(active)
            toks = []
            for _ in range(n):
                tok = self._decode(tok, pos, mask)
                toks.append(tok)
                pos = pos + 1
            toks = self._gathered(torch.stack(toks))
        toks_host = toks.cpu().numpy()          # [n, B]
        out = []
        for i in active:
            req = self.slots[i]
            for step_i in range(n):
                t = int(toks_host[step_i, i])
                req.output.append(t)
                self.pos[i] += 1
                self.last_tok[i] = t
                out.append((req.rid, t))
                if len(req.output) >= req.max_new_tokens or t in req.stop_ids:
                    break                       # cut the overshoot
            self._maybe_finish(i)
        global_profile.add("serve_decode_tokens", len(out))
        return out

    def busy(self) -> bool:
        return bool(self.waiting or self.prefilling or any(s is not None for s in self.slots))

    def run(self, requests: list[tuple[list[int], int]], burst: int = 1) -> dict[int, list[int]]:
        """Drain a list of (prompt, max_new_tokens); returns rid -> output.
        burst > 1 decodes that many tokens a step_burst once admissions
        have drained."""
        rids = [self.submit(p, n) for p, n in requests]
        while self.busy():
            if burst > 1:
                self.step_burst(burst)
            else:
                self.step()
        return {rid: self.requests[rid].output for rid in rids}
