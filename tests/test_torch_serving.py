"""Continuous batching (runtime/serving.py) on the CPU: the mirrors of
tests/test_serving.py's single-host tests on the port's dense model.

The model is tests/test_serving.py's: the synthetic TINY_TEST GGUF at Q8_0,
seed 9, loaded in the dense mode. There a batch-1 engine and the batched
server compute the same function (no kernel takes a different tier at
another batch), so each request's greedy stream must equal the port's own
LlamaEngine's on the same prompt exactly, as the JAX tests hold their
server to the JAX engine. The scenarios (`SCENARIOS`) are plain functions
of an engine class, so tests/test_torch_serving_jax.py runs the same calls
through the JAX ContinuousBatchingEngine and compares the streams.

Besides the mirrors: `mesh=` raises (ROADMAP.md A.7), a prompt that fills
the cache is refused, a last chunk that would run past max_seq_len is
trimmed (the repair of the JAX engine's clamped write, ROADMAP.md reference
weak spots), and the profile's serving phases and token counter.
"""
import pytest
import torch

from zgml_tpu_torch.io.gguf import GGMLType
from zgml_tpu_torch.io.llama_loader import load_llama
from zgml_tpu_torch.runtime.engine import LlamaEngine
from zgml_tpu_torch.runtime.profile import global_profile
from zgml_tpu_torch.runtime.serving import ContinuousBatchingEngine
from zgml_tpu_torch.utils.synthetic import TINY_TEST, write_synthetic_llama_gguf


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "t.gguf"
    write_synthetic_llama_gguf(str(path), TINY_TEST, GGMLType.Q8_0, seed=9)
    return str(path)


@pytest.fixture(scope="module")
def model(gguf_path):
    m, gf = load_llama(gguf_path, device="cpu", mode="dense")
    gf.close()
    return m


def _drain(serve, emissions=None):
    while any(s is not None for s in serve.slots) or serve.waiting or serve.prefilling:
        for rid, t in serve.step():
            if emissions is not None:
                emissions.setdefault(rid, []).append(t)


# -- the scenarios of tests/test_serving.py, as functions of an engine class -------

def batched(engine_cls, model):
    serve = engine_cls(model, max_batch=4)
    outs = serve.run([(p, 6) for p in ([1, 2, 3], [10, 20, 30, 40], [7])])
    return [outs[rid] for rid in sorted(outs)]


def more_requests_than_slots(engine_cls, model):
    serve = engine_cls(model, max_batch=2)
    outs = serve.run([([i + 1, i + 2], 4) for i in range(5)])
    return [outs[rid] for rid in sorted(outs)]


def mid_flight_admission(engine_cls, model):
    """rid a's and rid b's decode emissions, b submitted while a decodes."""
    serve = engine_cls(model, max_batch=2)
    emissions: dict[int, list[int]] = {}
    rid_a = serve.submit([5, 6, 7], 8)
    for _ in range(3):
        for rid, t in serve.step():
            emissions.setdefault(rid, []).append(t)
    rid_b = serve.submit([9, 9], 5)
    _drain(serve, emissions)
    return [emissions[rid_a], emissions[rid_b]]


def int8_cache(engine_cls, model):
    serve = engine_cls(model, max_batch=2, cache_dtype="int8")
    outs = serve.run([([1, 2, 3], 4), ([4, 5], 4)])
    return [outs[rid] for rid in sorted(outs)]


def burst(engine_cls, model):
    """The streams of run(burst=4), then those of run() stepwise."""
    prompts = [[1, 2, 3], [10, 20, 30, 40], [5, 6]]
    out = []
    for b in (4, 1):
        got = engine_cls(model, max_batch=4).run([(p, 9) for p in prompts], burst=b)
        out.append([got[r] for r in sorted(got)])
    return out


def chunked_admission(engine_cls, model):
    """(r0's emissions on the 3 steps that carry r1's 3 prefill chunks,
    r0's output, r1's output)."""
    serve = engine_cls(model, max_batch=2, prefill_chunk=4)
    r0 = serve.submit([1, 2, 3], 12)
    for _ in range(3):
        serve.step()
    r1 = serve.submit(list(range(1, 12)), 4)      # 11 tokens: 3 chunks
    during = 0
    for _ in range(3):
        during += sum(1 for rid, _ in serve.step() if rid == r0)
    _drain(serve)
    return [during, serve.requests[r0].output, serve.requests[r1].output]


SCENARIOS = {"batched": batched, "more_requests_than_slots": more_requests_than_slots,
             "mid_flight_admission": mid_flight_admission, "int8_cache": int8_cache,
             "burst": burst, "chunked_admission": chunked_admission}


# -- the mirrors -----------------------------------------------------------------

def _single(model, prompt, n, **kw):
    return LlamaEngine(model, **kw).generate(prompt, n)


def test_batched_decode_matches_single(model):
    prompts = [[1, 2, 3], [10, 20, 30, 40], [7]]
    assert batched(ContinuousBatchingEngine, model) == [_single(model, p, 6) for p in prompts]


def test_more_requests_than_slots(model):
    """Slot reuse: 5 requests through 2 slots."""
    want = [_single(model, [i + 1, i + 2], 4) for i in range(5)]
    assert more_requests_than_slots(ContinuousBatchingEngine, model) == want


def test_mid_flight_admission(model):
    """A request submitted while another decodes does not disturb it; step
    emits decode tokens (the prefill's first token is not emitted)."""
    got_a, got_b = mid_flight_admission(ContinuousBatchingEngine, model)
    assert got_a == _single(model, [5, 6, 7], 8)[1:]
    assert got_b == _single(model, [9, 9], 5)[1:]


def test_int8_cache_serving(model):
    """Over the int8 cache: every request gets its tokens, and, as the dense
    model's batch-1 engine over the int8 cache runs the same K9 prefill and
    K8 decode function, the same streams."""
    got = int8_cache(ContinuousBatchingEngine, model)
    assert all(len(v) == 4 for v in got)
    assert got == [_single(model, p, 4, cache_dtype="int8") for p in ([1, 2, 3], [4, 5])]


def test_burst_matches_stepwise(model):
    """step_burst emits the stepwise streams, overshoot cut on the host."""
    got, want = burst(ContinuousBatchingEngine, model)
    assert got == want
    assert want == [_single(model, p, 9) for p in ([1, 2, 3], [10, 20, 30, 40], [5, 6])]


def test_chunked_admission_interleaves(model):
    """A long prompt does not stall decoding slots: with prefill_chunk 4 and
    an 11-token prompt, r0 emits on each of the 3 steps that carry a chunk,
    and r1's output equals the single engine's on its prompt."""
    during, out0, out1 = chunked_admission(ContinuousBatchingEngine, model)
    assert during >= 3, during
    assert len(out0) == 12
    assert out1 == _single(model, list(range(1, 12)), 4)


# -- beyond the mirrors ----------------------------------------------------------

def test_mesh_raises(model):
    """A mesh the server cannot serve over raises: max_batch not divisible by
    its dp, or a tp the model was not sharded for (mesh serving itself runs
    in tests/test_torch_parallel_serving.py)."""
    from zgml_tpu_torch.parallel.mesh import Mesh

    def mesh(dp, tp):
        return Mesh({"dp": dp, "tp": tp}, {"dp": 0, "tp": 0}, {}, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        ContinuousBatchingEngine(model, max_batch=8, mesh=mesh(3, 1))
    with pytest.raises(ValueError, match="shard_llama_params"):
        ContinuousBatchingEngine(model, max_batch=2, mesh=mesh(1, 2))


def test_submit_rejects_what_the_cache_cannot_hold(model):
    serve = ContinuousBatchingEngine(model, max_batch=2)
    with pytest.raises(ValueError, match="SequenceTooLong"):
        serve.submit(list(range(1, TINY_TEST.max_seq_len + 1)), 4)
    with pytest.raises(ValueError, match="empty"):
        serve.submit([], 4)
    assert serve.submit(list(range(1, TINY_TEST.max_seq_len)), 4) == 0


def test_padded_last_chunk_is_trimmed_at_the_cache_end(model):
    """prefill_chunk 24 does not divide max_seq_len 64: a 60-token prompt's
    last chunk starts at 48, and padded to 24 it would run past the cache.
    The server trims it to 16 (the JAX engine clamps its write instead and
    corrupts the cache), so its stream and its last prefill logits equal the
    batch-1 engine's, which trims the same way, and a second request in the
    other slot is untouched."""
    prompt = [(7 * i) % 250 + 1 for i in range(60)]
    serve = ContinuousBatchingEngine(model, max_batch=2, prefill_chunk=24)
    seen, last = [], {}
    prefill = serve._prefill_slot

    def spy(tokens, slot, pos, n_valid):
        out = prefill(tokens, slot, pos, n_valid)
        seen.append((slot, tokens.shape[1], pos, n_valid))
        last[slot] = out.clone()             # each chunk's: the last one stays
        return out
    serve._prefill_slot = spy
    outs = serve.run([(prompt, 3), ([3, 4, 5], 6)])
    assert (0, 16, 48, 12) in seen
    assert torch.equal(last[0], LlamaEngine(model, prefill_chunk=24).prefill(prompt))
    assert outs[0] == _single(model, prompt, 3, prefill_chunk=24)
    assert outs[1] == _single(model, [3, 4, 5], 6, prefill_chunk=24)


def test_profile_counts_the_serving_phases(model):
    """serve_prefill / serve_decode phases and the serve_decode_tokens
    counter, as the JAX engine records them."""
    global_profile.reset()
    serve = ContinuousBatchingEngine(model, max_batch=2)
    outs = serve.run([([1, 2, 3], 5), ([4, 5], 3)], burst=2)
    assert global_profile.phase_calls["serve_prefill"] == 2
    assert global_profile.phase_calls["serve_decode"] >= 1
    # every emitted token but the prefills' first ones comes from a decode step
    assert global_profile.counters["serve_decode_tokens"] == sum(len(v) - 1
                                                                for v in outs.values())


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_one_token_chunks(model, cache_dtype):
    """prefill_chunk 1: every prefill chunk is a single token into a slot
    (flash through kv_row, not the decode kernel), and the streams equal the
    batch-1 engine's at the same chunk."""
    serve = ContinuousBatchingEngine(model, max_batch=2, prefill_chunk=1, cache_dtype=cache_dtype)
    outs = serve.run([([1, 2, 3], 4), ([5, 6], 3)])
    assert outs == {0: _single(model, [1, 2, 3], 4, prefill_chunk=1, cache_dtype=cache_dtype),
                    1: _single(model, [5, 6], 3, prefill_chunk=1, cache_dtype=cache_dtype)}
