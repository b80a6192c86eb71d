"""The port's Whisper (zgml_tpu_torch/models/whisper.py, data/audio.py,
io/hf_loaders.load_whisper_hf) and K4's f32 form against the JAX package's,
on the CPU.

Mirrors the five Whisper cases and test_log_mel_spectrogram of
tests/test_whisper_cli.py on the port, then holds the port to the JAX model
built from the same numpy params (io/llama_loader.whisper_params_from_jax;
init_params from one seed draws the same values in both): encode_features
at an even and an odd T_mel (XLA's SAME padding of the stride-2 conv),
decode, precompute_cross_kv, decode_step's logits over the f32 cache and
transcribe_greedy's tokens, and load_whisper_hf with and without a
config.json beside the file. Everything is f32 on both sides, the sums in
another order: within 1e-5 * max|.| (measured: at most 4.4e-7), the tokens
exactly. log_mel_spectrogram within 1e-5 absolute of
JAX's (measured 1.2e-7: the port transforms in float64, numpy's f32
transform is within ~1e-7 of exact), mel_filterbank bit-equal.

K4's f32 form: its plain version (attention.decode_attention_ref) against
the JAX Pallas decode kernel in interpret mode on f32 K / V at S 448 and S
1500 (JAX pads the cache to 1536 there), kv_len 1 and S, n_rep 1 and 4,
within 1e-5 * max|o|.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zgml_tpu.data import audio as jaudio
from zgml_tpu.io.hf_loaders import load_whisper_hf as jax_load_whisper_hf
from zgml_tpu.models import whisper as jwhisper
from zgml_tpu.ops import attention as jattn

from zgml_tpu_torch.data.audio import log_mel_spectrogram, mel_filterbank, pad_or_trim
from zgml_tpu_torch.io.hf_loaders import load_whisper_hf
from zgml_tpu_torch.io.llama_loader import whisper_params_from_jax
from zgml_tpu_torch.io.safetensors import save_safetensors
from zgml_tpu_torch.models.gpt import sinusoidal_positions
from zgml_tpu_torch.models.whisper import WhisperConfig, WhisperModel, init_params
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.ops.attention import decode_attention_ref
from zgml_tpu_torch.runtime.profile import global_profile

torch.set_num_threads(1)

CFG = WhisperConfig(n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_heads=4,
                    n_audio_layers=2, vocab_size=64, n_text_ctx=16, n_text_state=32,
                    n_text_heads=4, n_text_layers=2)
# the parity config: d 64, 4 heads of 16; weights at std 0.3, where the tied
# head's greedy tokens vary (at the JAX init's 0.02 they repeat one token)
PARITY = dataclasses.replace(CFG, n_audio_state=64, n_text_state=64)
PARITY_SCALE = 0.3
RTOL = 1e-5
MEL_ATOL = 1e-5


def _model(seed, cfg=CFG):
    return WhisperModel(cfg, init_params(cfg, seed=seed, device="cpu"))


def _mel(seed, t=32, n_mels=16):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, t, n_mels)).astype(np.float32))


def test_whisper_encode_decode_shapes():
    model = _model(0)
    enc = model.encode_features(_mel(0))
    assert enc.shape == (1, 16, 32)          # the stride-2 conv halves T
    logits = model.decode([[1, 2, 3]], enc)
    assert logits.shape == (1, 3, 64) and bool(torch.isfinite(logits).all())


def test_whisper_transcribe_greedy_deterministic():
    model = _model(1)
    a = model.transcribe_greedy(_mel(1), bos=1, eos=2, max_tokens=6)
    assert a == model.transcribe_greedy(_mel(1), bos=1, eos=2, max_tokens=6) and a[0] == 1


def test_whisper_causality():
    """Decoder token t must not depend on future tokens."""
    model = _model(2)
    enc = model.encode_features(_mel(2))
    l1, l2 = model.decode([[1, 2, 3]], enc), model.decode([[1, 2, 9]], enc)
    torch.testing.assert_close(l1[0, :2], l2[0, :2], rtol=1e-4, atol=1e-5)


def test_whisper_cached_decode_matches_uncached():
    """decode_step (K4's f32 form's plain version over the cache and the
    cross K / V) gives the stateless decoder's tokens, token for token."""
    model = _model(3)
    mel = _mel(3)
    enc = model.encode_features(mel)
    toks = [1]
    for _ in range(8):
        toks.append(int(torch.argmax(model.decode([toks], enc)[0, -1])))
    global_profile.reset()
    assert model.transcribe_greedy(mel, bos=1, eos=-1, max_tokens=8) == toks
    assert global_profile.tier_summary() == {"decode_attention_f32": {"ref": 2 * 2 * 8}}


def _hf_tensors(p, enc_pos):
    """HF Whisper names for a JAX params tree (numpy): 2-D weights [out,
    in], the convolutions [out, in, k] from lax's [k, in, out]."""
    def t(a):
        return np.ascontiguousarray(np.asarray(a, np.float32).T)
    out = {"model.encoder.conv1.weight": np.asarray(p["conv1_w"]).transpose(2, 1, 0),
           "model.encoder.conv1.bias": p["conv1_b"],
           "model.encoder.conv2.weight": np.asarray(p["conv2_w"]).transpose(2, 1, 0),
           "model.encoder.conv2.bias": p["conv2_b"],
           "model.encoder.embed_positions.weight": enc_pos,
           "model.encoder.layer_norm.weight": p["enc_ln_post"]["g"],
           "model.encoder.layer_norm.bias": p["enc_ln_post"]["b"],
           "model.decoder.embed_tokens.weight": p["tok_embd"],
           "model.decoder.embed_positions.weight": p["pos_embd"],
           "model.decoder.layer_norm.weight": p["dec_ln"]["g"],
           "model.decoder.layer_norm.bias": p["dec_ln"]["b"]}

    def attn(pre, a):
        out.update({pre + ".q_proj.weight": t(a["wq"]), pre + ".q_proj.bias": a["bq"],
                    pre + ".k_proj.weight": t(a["wk"]), pre + ".v_proj.weight": t(a["wv"]),
                    pre + ".v_proj.bias": a["bv"], pre + ".out_proj.weight": t(a["wo"]),
                    pre + ".out_proj.bias": a["bo"]})

    def block(pre, lyr):
        attn(pre + ".self_attn", lyr["attn"])
        for ln, hf in (("ln_1", "self_attn_layer_norm"), ("ln_2", "final_layer_norm"),
                       ("ln_x", "encoder_attn_layer_norm")):
            if ln in lyr:
                out[f"{pre}.{hf}.weight"], out[f"{pre}.{hf}.bias"] = lyr[ln]["g"], lyr[ln]["b"]
        out.update({pre + ".fc1.weight": t(lyr["w_fc"]), pre + ".fc1.bias": lyr["b_fc"],
                    pre + ".fc2.weight": t(lyr["w_proj"]), pre + ".fc2.bias": lyr["b_proj"]})
        if "cross" in lyr:
            attn(pre + ".encoder_attn", lyr["cross"])
    for i, lyr in enumerate(p["enc_layers"]):
        block(f"model.encoder.layers.{i}", lyr)
    for i, lyr in enumerate(p["dec_layers"]):
        block(f"model.decoder.layers.{i}", lyr)
    return {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in out.items()}


def _jax_pair(seed, cfg=PARITY, scale=PARITY_SCALE):
    jcfg = jwhisper.WhisperConfig(**dataclasses.asdict(cfg))
    jm = jwhisper.WhisperModel(jcfg, jwhisper.init_params(jcfg, seed=seed, scale=scale))
    npp = jax.tree_util.tree_map(np.asarray, jm.params)
    return jm, WhisperModel(cfg, whisper_params_from_jax(npp, cfg, device="cpu"))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err / float(np.abs(want).max())


@pytest.mark.parametrize("config_json", [True, False], ids=["config_json", "heads_d_over_64"])
def test_whisper_hf_loader_roundtrip(tmp_path, config_json):
    """An HF-named file from the JAX package's params: the port's
    load_whisper_hf infers JAX's config (head counts from config.json, else
    d // 64), and its encoder states and decoder logits equal JAX's loaded
    model's within RTOL."""
    cfg = PARITY if config_json else dataclasses.replace(    # d 64: one head of 64
        PARITY, n_audio_heads=1, n_text_heads=1)
    jcfg = jwhisper.WhisperConfig(**dataclasses.asdict(cfg))
    p = jax.tree_util.tree_map(np.asarray, jwhisper.init_params(jcfg, seed=4, scale=0.1))
    path = tmp_path / "whisper.safetensors"
    save_safetensors(path, _hf_tensors(p, sinusoidal_positions(cfg.n_audio_ctx,
                                                               cfg.n_audio_state)))
    if config_json:
        (tmp_path / "config.json").write_text(json.dumps(
            {"encoder_attention_heads": cfg.n_audio_heads,
             "decoder_attention_heads": cfg.n_text_heads}))
    jm = jax_load_whisper_hf(str(path))
    tm = load_whisper_hf(str(path), device="cpu")
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg == cfg
    mel = _mel(5, 32, cfg.n_mels)
    je = jm.encode_features(jnp.asarray(mel.numpy()))
    te = tm.encode_features(mel)
    _close(te, je)
    toks = [[1, 5, 9]]
    _close(tm.decode(toks, te), jm.decode(jnp.asarray(toks, jnp.int32), je))


def test_init_params_match_jax():
    jcfg = jwhisper.WhisperConfig(**dataclasses.asdict(PARITY))
    jp = jax.tree_util.tree_map(np.asarray, jwhisper.init_params(jcfg, seed=6))
    tp = whisper_params_from_jax(jp, PARITY, device="cpu")
    mine = init_params(PARITY, seed=6, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(
        mine, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0])
    assert len(flat) == len(want)
    for path, t in flat:
        assert torch.equal(t, want[path]), path


@pytest.mark.parametrize("t_mel", [32, 31], ids=["even", "odd"])
def test_encode_features_match_jax(t_mel):
    jm, tm = _jax_pair(7)
    mel = _mel(8, t_mel)
    je = jm.encode_features(jnp.asarray(mel.numpy()))
    te = tm.encode_features(mel)
    assert te.shape == (1, (t_mel + 1) // 2, PARITY.n_audio_state)
    _close(te, je)


def test_decoder_matches_jax():
    """decode, precompute_cross_kv and four decode_step logits from the
    same encoder states (JAX's), each against JAX's."""
    jm, tm = _jax_pair(9)
    je = jm.encode_features(jnp.asarray(_mel(10).numpy()))
    te = torch.from_numpy(np.array(je))
    toks = [[1, 5, 9, 7]]
    _close(tm.decode(toks, te), jm.decode(jnp.asarray(toks, jnp.int32), je))
    jx, tx = jm.precompute_cross_kv(je), tm.precompute_cross_kv(te)
    for (jk, jv), (tk, tv) in zip(jx, tx):
        assert tk.is_contiguous() and tv.is_contiguous()
        _close(tk, jk)
        _close(tv, jv)
    jc, tc = jm.init_cache(1), tm.init_cache(1)
    assert tc["k"].dtype == torch.float32
    for i, t in enumerate(toks[0]):
        jl, jc = jm.decode_step(jnp.asarray([[t]], jnp.int32), jx, jc, i)
        tl, tc = tm.decode_step([[t]], tx, tc, i)
        _close(tl, jl)
        _close(tc["k"][:, 0, :, :i + 1], np.stack([np.asarray(c)[0, :, :i + 1]
                                                   for c in jc["k"]]))


@pytest.mark.parametrize("seed", [11, 12])
def test_transcribe_greedy_matches_jax(seed):
    jm, tm = _jax_pair(seed)
    mel = _mel(seed + 100)
    want = jm.transcribe_greedy(jnp.asarray(mel.numpy()), bos=1, eos=2, max_tokens=10)
    got = tm.transcribe_greedy(mel, bos=1, eos=2, max_tokens=10)
    assert got == want and len(set(got)) > 2


def test_log_mel_spectrogram():
    """The JAX test's tones on the port (shapes, ranges, a higher tone in a
    higher mel bin), then against JAX's: within MEL_ATOL at 80 and 128
    mels (Whisper large-v3's), on the tones and 30 s of tones plus noise."""
    sr = 16000
    t = np.arange(sr) / sr
    mel_lo = log_mel_spectrogram(np.sin(2 * np.pi * 200 * t), device="cpu")
    mel_hi = log_mel_spectrogram(np.sin(2 * np.pi * 4000 * t), device="cpu")
    assert mel_lo.shape == (100, 80) and bool(torch.isfinite(mel_lo).all())
    assert int(torch.argmax(mel_lo.mean(0))) < int(torch.argmax(mel_hi.mean(0)))
    assert float(mel_lo.max()) <= 2.0 and float(mel_lo.min()) >= -2.0
    fb = mel_filterbank()
    assert fb.shape == (80, 201) and (fb >= 0).all()
    padded = pad_or_trim(mel_lo, 3000)
    assert padded.shape == (3000, 80) and not bool(padded[100:].any())
    assert pad_or_trim(padded, 100).shape == (100, 80)
    rng = np.random.default_rng(0)
    long = 30 * sr
    tones = sum(np.sin(2 * np.pi * f * np.arange(long) / sr) for f in (220, 440, 1250, 3100))
    waves = [np.sin(2 * np.pi * 200 * t), np.sin(2 * np.pi * 4000 * t),
             0.2 * tones + 0.05 * rng.standard_normal(long)]
    for n_mels in (80, 128):
        np.testing.assert_array_equal(mel_filterbank(n_mels), jaudio.mel_filterbank(n_mels))
        for wave in waves:
            want = jaudio.log_mel_spectrogram(wave, n_mels)
            got = log_mel_spectrogram(wave, n_mels, device="cpu").numpy()
            assert got.shape == want.shape
            assert float(np.abs(got - want).max()) <= MEL_ATOL


@pytest.mark.parametrize("s,kv_len", [(448, 1), (448, 448), (1500, 1), (1500, 1500),
                                      (1500, 777)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["n_rep1", "n_rep4"])
def test_plain_f32_decode_matches_jax_kernel(s, kv_len, hq, hkv):
    """K4's f32 form's plain version against JAX's Pallas decode kernel
    (interpret mode) on f32 K / V; at S 1500 JAX pads the cache to 1536."""
    rng = np.random.default_rng(s + kv_len + hq)
    b, d = 2, 64
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    want = jattn.decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len)
    global_profile.reset()
    got = dispatch.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), kv_len)
    assert global_profile.tier_summary() == {"decode_attention_f32": {"ref": 1}}
    _close(got, want)
    torch.testing.assert_close(got, decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.full((b,), kv_len)), rtol=0, atol=0)
