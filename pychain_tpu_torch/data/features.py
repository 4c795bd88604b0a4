"""Native acoustic feature extraction: wav -> log-mel filterbanks.

The port's counterpart of ``pychain_tpu/data/features.py``.  The
reference consumes features Kaldi computed offline
(`compute-fbank-feats`); together with the transcript->graph builder
this module removes the last offline dependency: wav in, LF-MMI
training out.  Two implementations with tested parity:

* :func:`fbank` — numpy, one utterance, the behavioural spec (the JAX
  package's, copied as it is, with the other numpy functions),
* :func:`fbank_batch` — PyTorch, batched, on an explicit device
  (``device=None`` means the card), so feature extraction runs on the
  GPU as part of the input pipeline: frames by ``unfold``, one
  ``torch.fft.rfft`` and one (F, M) product; :func:`cmvn_batch` and
  :func:`add_deltas_batch` likewise.

The parameters follow Kaldi's conventions (25 ms windows, 10 ms shift,
preemphasis 0.97, the "povey" window, snip_edges frame counting,
mel scale 1127*ln(1+f/700)); this is a faithful same-design
implementation, not a bit-exact clone of Kaldi's binaries.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = 0.0        # <= 0: offset from Nyquist
    preemphasis: float = 0.97
    window: str = "povey"         # povey | hann | hamming
    remove_dc: bool = True
    log_floor: float = 1e-10

    @property
    def frame_length(self) -> int:
        return int(round(self.sample_rate * self.frame_length_ms / 1000.0))

    @property
    def frame_shift(self) -> int:
        return int(round(self.sample_rate * self.frame_shift_ms / 1000.0))

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * np.pi / (n - 1)
    t = np.arange(n)
    hann = 0.5 - 0.5 * np.cos(a * t)
    if cfg.window == "hann":
        w = hann
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * t)
    elif cfg.window == "povey":
        w = hann ** 0.85
    else:
        raise ValueError(f"unknown window {cfg.window!r}")
    return w.astype(np.float64)


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """(num_bins, fft_size//2 + 1) triangular mel filterbank matrix."""
    nyquist = cfg.sample_rate / 2.0
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= cfg.low_freq < high <= nyquist):
        raise ValueError("bad low/high frequency range")
    n_fft_bins = cfg.fft_size // 2 + 1
    fft_freqs = np.arange(n_fft_bins) * (cfg.sample_rate / cfg.fft_size)
    mel_lo, mel_hi = _mel(cfg.low_freq), _mel(high)
    centers = np.linspace(mel_lo, mel_hi, cfg.num_bins + 2)
    m = _mel(fft_freqs)
    banks = np.zeros((cfg.num_bins, n_fft_bins), np.float64)
    for b in range(cfg.num_bins):
        left, center, right = centers[b], centers[b + 1], centers[b + 2]
        up = (m - left) / (center - left)
        down = (right - m) / (right - center)
        banks[b] = np.clip(np.minimum(up, down), 0.0, None)
    return banks


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    """snip_edges frame count: frames that fit entirely in the signal."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def fbank(samples, cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Log-mel filterbank features, (num_frames, num_bins) float32.

    ``samples``: 1-D float array in [-1, 1] (or int16, scaled down).
    """
    x = np.asarray(samples)
    if x.ndim != 1:
        raise ValueError("one utterance at a time; see fbank_batch")
    if x.dtype == np.int16:
        x = x.astype(np.float64) / 32768.0
    x = x.astype(np.float64)
    T = num_frames(x.shape[0], cfg)
    if T == 0:
        return np.zeros((0, cfg.num_bins), np.float32)
    idx = (np.arange(T)[:, None] * cfg.frame_shift
           + np.arange(cfg.frame_length)[None, :])
    frames = x[idx]                               # (T, L)
    if cfg.remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis > 0:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * pre
    frames = frames * _window(cfg)[None, :]
    spec = np.fft.rfft(frames, n=cfg.fft_size, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)
    mel = power @ mel_banks(cfg).T                # (T, num_bins)
    return np.log(np.maximum(mel, cfg.log_floor)).astype(np.float32)


def _on(a, device, dtype=None) -> torch.Tensor:
    """A tensor or an array as a tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


def _samples(samples, device) -> torch.Tensor:
    """(B, N) float32 samples on ``device``; int16 input is scaled by
    1 / 32768 on the host first, as :func:`fbank` scales it."""
    if isinstance(samples, torch.Tensor):
        x = samples
        if x.dtype == torch.int16:
            x = x.to(torch.float32) / 32768.0
    else:
        a = np.asarray(samples)
        if a.dtype == np.int16:
            a = a.astype(np.float32) / 32768.0
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return x.to(device=device, dtype=torch.float32)


def fbank_batch(samples, cfg: FbankConfig = FbankConfig(), device=None):
    """Batched log-mel filterbanks on ``device`` (``None``: the card).

    ``samples``: (B, N) float32 in [-1, 1] (or int16; pad with zeros and
    compute feature lengths with :func:`num_frames` of the true sample
    counts), a tensor or an array.  Returns (B, T, num_bins) float32 with
    T = num_frames(N): the frames by ``unfold``, then DC removal,
    pre-emphasis, the window, ``torch.fft.rfft``, the power spectrum, the
    mel product and the log floor, as :func:`fbank` computes them in
    float64 and as the JAX package's ``fbank_batch`` does in float32."""
    dev = resolve_device(device)
    x = _samples(samples, dev)
    if x.ndim != 2:
        raise ValueError("expected (B, N) samples")
    T = num_frames(x.shape[1], cfg)
    if T == 0:
        return torch.zeros((x.shape[0], 0, cfg.num_bins), device=dev)
    frames = x.unfold(1, cfg.frame_length, cfg.frame_shift)[:, :T]
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=2, keepdim=True)
    if cfg.preemphasis > 0:
        pre = torch.cat([frames[:, :, :1], frames[:, :, :-1]], dim=2)
        frames = frames - cfg.preemphasis * pre
    window = torch.as_tensor(_window(cfg), dtype=torch.float32, device=dev)
    spec = torch.fft.rfft(frames * window, n=cfg.fft_size, dim=2)
    power = spec.real ** 2 + spec.imag ** 2
    banks = torch.as_tensor(mel_banks(cfg).T, dtype=torch.float32,
                            device=dev)
    return torch.log(torch.clamp(power @ banks, min=cfg.log_floor))


def mfcc(samples, cfg: FbankConfig = FbankConfig(), num_ceps: int = 13):
    """MFCCs: DCT-II (orthonormal) of the log-mel filterbanks,
    keeping the first ``num_ceps`` coefficients."""
    if num_ceps > cfg.num_bins:
        raise ValueError("num_ceps cannot exceed num_bins")
    fb = fbank(samples, cfg).astype(np.float64)
    return _dct_matrix(cfg.num_bins, num_ceps).dot(fb.T).T.astype(
        np.float32)


def _dct_matrix(n: int, k: int) -> np.ndarray:
    """(k, n) orthonormal DCT-II matrix."""
    m = np.cos(np.pi / n * (np.arange(n) + 0.5)[None, :]
               * np.arange(k)[:, None])
    m *= np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return m


def cmvn(feats, length=None, norm_vars: bool = False):
    """Per-utterance cepstral mean (and optional variance)
    normalization over the real frames.  feats (T, D) numpy.
    Frames beyond ``length`` are zeroed — matching
    :func:`cmvn_batch`'s masked output."""
    x = np.asarray(feats, np.float32)
    n = x.shape[0] if length is None else int(length)
    if n < 1:
        return x
    mean = x[:n].mean(axis=0)
    out = x - mean
    if norm_vars:
        std = x[:n].std(axis=0)
        out = out / np.maximum(std, 1e-8)
    out[n:] = 0.0
    return out


def add_deltas(feats, window: int = 2, order: int = 2):
    """Append delta (and delta-delta, ...) features, Kaldi-style
    regression over ``window`` frames with edge replication.
    feats (T, D) -> (T, D * (order + 1))."""
    x = np.asarray(feats, np.float32)
    T = x.shape[0]
    if T == 0:
        return x.reshape(0, x.shape[1] * (order + 1))
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    outs = [x]
    cur = x
    for _ in range(order):
        pad = np.concatenate([np.repeat(cur[:1], window, axis=0), cur,
                              np.repeat(cur[-1:], window, axis=0)])
        d = np.zeros_like(cur)
        for i in range(1, window + 1):
            d += i * (pad[window + i:window + i + T]
                      - pad[window - i:window - i + T])
        cur = d / denom
        outs.append(cur)
    return np.concatenate(outs, axis=1)


def cmvn_batch(feats, lengths=None, norm_vars: bool = False,
               device=None):
    """Batched per-utterance CMVN on ``device`` (``None``: the card).
    feats (B, T, D); with ``lengths`` (B,), the statistics cover the real
    frames only and padding comes out zero, as :func:`cmvn` gives it."""
    dev = resolve_device(device)
    x = _on(feats, dev, torch.float32)
    B, T, D = x.shape
    if lengths is None:
        n = torch.full((B, 1, 1), float(T), device=dev)
        mask = torch.ones((B, T, 1), device=dev)
    else:
        lens = _on(lengths, dev)
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]
                ).to(torch.float32)[:, :, None]
        n = torch.clamp(lens, min=1).to(torch.float32)[:, None, None]
    mean = (x * mask).sum(dim=1, keepdim=True) / n
    out = (x - mean) * mask
    if norm_vars:
        var = (torch.square(x - mean) * mask).sum(dim=1, keepdim=True) / n
        out = out / torch.clamp(torch.sqrt(var), min=1e-8)
    return out


def add_deltas_batch(feats, window: int = 2, order: int = 2, device=None):
    """Batched delta features on ``device`` (``None``: the card):
    (B, T, D) -> (B, T, D*(order+1)), the same regression and edge
    replication as :func:`add_deltas`."""
    dev = resolve_device(device)
    x = _on(feats, dev, torch.float32)
    T = x.shape[1]
    denom = 2.0 * sum(i * i for i in range(1, window + 1))
    outs = [x]
    cur = x
    for _ in range(order):
        pad = torch.cat([cur[:, :1].expand(-1, window, -1), cur,
                         cur[:, -1:].expand(-1, window, -1)], dim=1)
        d = torch.zeros_like(cur)
        for i in range(1, window + 1):
            d = d + i * (pad[:, window + i:window + i + T]
                         - pad[:, window - i:window - i + T])
        cur = d / denom
        outs.append(cur)
    return torch.cat(outs, dim=2)


# ----------------------------------------------------------------------
# Minimal WAV I/O (PCM16 / float32 mono), no external deps
# ----------------------------------------------------------------------

def read_wav(filename: str):
    """Read a mono RIFF WAV (PCM16 or IEEE float32).  Returns
    (samples float32 in [-1, 1], sample_rate)."""
    with open(filename, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError("no data chunk")
            tag, sz = struct.unpack("<4sI", hdr)
            if tag == b"fmt ":
                if sz < 16:
                    raise ValueError(f"malformed fmt chunk (size {sz})")
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.read(sz - 16)
            elif tag == b"data":
                raw = f.read(sz)
                break
            else:
                f.read(sz + (sz & 1))
        if fmt is None:
            raise ValueError("no fmt chunk")
        audio_fmt, channels, rate, _, _, bits = fmt
        if channels != 1:
            raise ValueError("mono only")
        if audio_fmt == 1 and bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif audio_fmt == 3 and bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float32)
        else:
            raise ValueError(f"unsupported format {audio_fmt}/{bits}bit")
        return x, rate


def write_wav(filename: str, samples, sample_rate: int) -> None:
    """Write mono PCM16."""
    x = np.clip(np.asarray(samples, np.float64), -1.0, 1.0)
    # round (not truncate) at the same 1/32768 scale the reader uses
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(
        "<i2").tobytes()
    with open(filename, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(pcm), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(pcm)))
        f.write(pcm)
