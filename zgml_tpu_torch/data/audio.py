"""Audio frontend: Whisper's log-mel spectrogram.

Counterpart of zgml_tpu/data/audio.py. The slaney mel filterbank is computed
as the JAX package computes it (numpy float64, then f32: bit-equal); the
reflect-padded centred STFT (hann window, n_fft 400, hop 160 at 16 kHz), the
power spectrum without its last frame (its transform in float64), the mel product, log10 clamped to
(max - 8) and the (x + 4) / 4 scaling run in torch on the caller's device
(the card unless device="cpu"). ``pad_or_trim`` fixes the frame axis to the
model's input length.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from zgml_tpu_torch.quant.packed import resolve_device

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30


def _hz_to_mel(f):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, np.float64)
    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    mel = 3.0 * f / 200.0
    above = f >= min_log_hz
    return np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    f = 200.0 * m / 3.0
    above = m >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] triangular filters, slaney area-normalized
    (numpy: the values of zgml_tpu/data/audio.py:43-59 bit for bit)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)            # slaney norm
    return fb.astype(np.float32)


def log_mel_spectrogram(audio, n_mels: int = 80, sr: int = SAMPLE_RATE,
                        device="cuda") -> torch.Tensor:
    """waveform [T] (numpy or torch) -> log-mel features f32 [n_frames, n_mels]
    on `device`, the Whisper convention of zgml_tpu/data/audio.py:62-84."""
    dev = resolve_device(device)
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    x = audio.reshape(-1).to(dev, torch.float32)
    window = torch.from_numpy(np.hanning(N_FFT + 1)[:-1].astype(np.float32)).to(dev)
    pad = N_FFT // 2
    x = torch.nn.functional.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP_LENGTH) * window          # [n_frames, N_FFT]
    # in float64: numpy's f32 transform (the JAX package's) is within ~1e-7
    # of the exact spectrum, torch's f32 one moved a pure tone's weak mel bins
    # by up to 2.4e-5 of the output (CPU)
    spec = (torch.fft.rfft(frames.double(), dim=-1).abs() ** 2).float()
    spec = spec[:-1]                                          # whisper drops the last frame
    mel = spec @ torch.from_numpy(mel_filterbank(n_mels, N_FFT, sr)).to(dev).T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(mel: torch.Tensor, n_frames: int = 3000) -> torch.Tensor:
    """Pad with zeros or trim the frame axis (0) to the model's input length."""
    t = mel.shape[0]
    if t >= n_frames:
        return mel[:n_frames]
    return torch.nn.functional.pad(mel, (0, 0, 0, n_frames - t))
