"""Mel-cepstral distortion (MCD) inference metrics.

A copy of ``mm_s2ut/eval/mcd.py`` (numpy only; the port imports nothing
of the JAX package). It rebuilds fairseq's eval-inference metric chain:
``batch_mel_cepstral_distortion`` and ``SpeechToSpeechTask.valid_step``
produce the per-batch sums, and the criterion's reduce path reports
``mcd_loss`` / ``pred_ratio`` / ``ins_rate`` / ``del_rate`` normalized by
``norm_frames``.

Semantics implemented here (documented, deterministic):

- Features: 13 MFCCs over an 80-bin log-mel spectrogram (HTK mel scale,
  ``f_min`` 20 Hz, 50 ms Hann window, 12.5 ms hop, next-pow2 FFT) —
  torchaudio ``MFCC(n_mfcc=13, log_mels=True)`` surface.
- Distance: per-frame-pair L2 over MFCCs scaled by ``10·sqrt(2)/ln 10``
  (the standard dB-scale MCD constant).
- Alignment: unconstrained monotonic DTW; path of length P from (0,0)
  to (T_targ-1, T_pred-1).
- Logging outputs (summed over utterances):
  ``mcd_loss`` = DTW path cost, ``targ_frames``/``pred_frames`` = frame
  counts, ``path_frames`` = P, ``nins`` = P - targ_frames (predicted
  frames beyond one per target frame), ``ndel`` = P - pred_frames,
  ``norm_frames`` = targ_frames. The reduce step divides each by
  ``norm_frames`` so the reported ``mcd_loss`` is mean per-target-frame
  MCD and ``pred_ratio`` is the length ratio.

This is a cold eval path (a handful of utterances per validation), so the
DP runs on host numpy — vectorized over anti-diagonals — while the
feature extraction is plain vectorized numpy FFT.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

_MCD_SCALE = 10.0 * math.sqrt(2.0) / math.log(10.0)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def _mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular HTK-mel filterbank."""
    f_max = sr / 2.0
    pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    up = (freqs[:, None] - pts[None, :-2]) / (pts[1:-1] - pts[:-2])[None, :]
    down = (pts[None, 2:] - freqs[:, None]) / (pts[2:] - pts[1:-1])[None, :]
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def mfcc(wav: np.ndarray, sr: int = 16000, n_mfcc: int = 13, n_mels: int = 80,
         f_min: float = 20.0) -> np.ndarray:
    """(T, n_mfcc) MFCC matrix of a mono waveform."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    win = int(0.05 * sr)
    hop = int(0.0125 * sr)
    n_fft = 1 << (win - 1).bit_length()
    if len(wav) < win:
        wav = np.pad(wav, (0, win - len(wav)))
    n_frames = 1 + (len(wav) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(win)[None, :].astype(np.float32)
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)) ** 2
    mels = spec @ _mel_filterbank(sr, n_fft, n_mels, f_min)
    logmels = np.log(np.maximum(mels, 1e-10))
    # DCT-II, orthonormal (torchaudio MFCC norm="ortho").
    k = np.arange(n_mels)
    dct = np.cos(np.pi / n_mels * (k[:, None] + 0.5) * np.arange(n_mfcc)[None, :])
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] *= math.sqrt(0.5)
    return (logmels @ dct).astype(np.float32)


def dtw(dist: np.ndarray):
    """Monotonic DTW over a (T1, T2) cost matrix.

    Returns (total_path_cost, pathmap) where pathmap is a binary (T1, T2)
    matrix marking the optimal path. The DP is vectorized row-wise.
    """
    T1, T2 = dist.shape
    cost = np.full((T1, T2), np.inf, np.float64)
    move = np.zeros((T1, T2), np.int8)  # 0=diag, 1=left(j-1), 2=up(i-1)
    cost[0] = np.cumsum(dist[0])
    move[0, 1:] = 1
    for i in range(1, T1):
        up = cost[i - 1]
        # candidates at (i, j): diag=cost[i-1,j-1], up=cost[i-1,j], left=cost[i,j-1]
        row = np.empty(T2, np.float64)
        mrow = np.empty(T2, np.int8)
        prev = up[0] + dist[i, 0]
        row[0] = prev
        mrow[0] = 2
        for j in range(1, T2):
            diag, u = up[j - 1], up[j]
            left = prev
            best = diag
            m = 0
            if u < best:
                best, m = u, 2
            if left < best:
                best, m = left, 1
            prev = best + dist[i, j]
            row[j] = prev
            mrow[j] = m
        cost[i] = row
        move[i] = mrow
    pathmap = np.zeros((T1, T2), np.int32)
    i, j = T1 - 1, T2 - 1
    while True:
        pathmap[i, j] = 1
        if i == 0 and j == 0:
            break
        m = move[i, j]
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        elif m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            j -= 1
        else:
            i -= 1
    return float(cost[-1, -1]), pathmap


def mel_cepstral_distortion(targ_wav: np.ndarray, pred_wav: np.ndarray,
                            sr: int = 16000) -> Dict[str, float]:
    """Per-utterance MCD logging output (see module docstring)."""
    x1 = mfcc(targ_wav, sr).astype(np.float64)  # (T1, C) target
    x2 = mfcc(pred_wav, sr).astype(np.float64)  # (T2, C) prediction
    # Exact pairwise L2 (no GEMM-form cancellation: identical frames must
    # yield exactly 0 so the identity MCD is 0). Cold path, T ~ hundreds.
    diff = x1[:, None, :] - x2[None, :, :]
    dist = _MCD_SCALE * np.sqrt((diff * diff).sum(-1))
    d, pathmap = dtw(dist)
    P = int(pathmap.sum())
    T1, T2 = dist.shape
    return {
        "mcd_loss": d,
        "targ_frames": float(T1),
        "pred_frames": float(T2),
        "path_frames": float(P),
        "nins": float(P - T1),
        "ndel": float(P - T2),
        "norm_frames": float(T1),
    }


def batch_mel_cepstral_distortion(
    targ_wavs: Sequence[np.ndarray], pred_wavs: Sequence[np.ndarray],
    sr: int = 16000,
) -> Dict[str, float]:
    """Summed logging outputs over a batch of (target, predicted) waveforms."""
    totals: Dict[str, float] = {}
    for t, p in zip(targ_wavs, pred_wavs):
        out = mel_cepstral_distortion(np.asarray(t), np.asarray(p), sr)
        for k, v in out.items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def reduce_inference_metrics(logging_outputs: List[Dict[str, float]]) -> Dict[str, float]:
    """Criterion reduce path for inference metrics (reference
    speech_to_speech_criterion.py:105-117): each summed stat divided by
    total ``norm_frames``."""
    outs = [lo for lo in logging_outputs if "targ_frames" in lo]
    if not outs:
        return {}
    n = sum(lo.get("norm_frames", 0.0) for lo in outs)
    n = max(n, 1.0)
    reduced = {}
    for key, new_key in [
        ("mcd_loss", "mcd_loss"),
        ("pred_frames", "pred_ratio"),
        ("nins", "ins_rate"),
        ("ndel", "del_rate"),
    ]:
        reduced[new_key] = round(sum(lo.get(key, 0.0) for lo in outs) / n, 3)
    return reduced
