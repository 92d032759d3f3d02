"""Waveform read and write without libsndfile (numpy only).

A copy of ``mm_s2ut/data/audio_io.py``'s readers: importing that module
would import the ``mm_s2ut`` package, which imports JAX.
``get_waveform`` reads ``.npy`` files and, by their first bytes, FLAC
(``data/flac.py``), Ogg/Vorbis (``data/ogg.py``, through the system's
libvorbisfile) and RIFF/WAVE (PCM 8/16/24/32, IEEE float).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE → (float32 samples (T, C) in [-1, 1], sample_rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM (or extensible, assume PCM)
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAVE format code {audio_format}")
    x = x.reshape(-1, channels) if channels > 1 else x[:, None]
    return x, sample_rate


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g, axis=0).astype(np.float32)


def get_waveform(
    path: str, *, use_sample_rate: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Load a mono waveform in [-1, 1] from ``.npy``, FLAC, Ogg/Vorbis or
    RIFF/WAVE; without libvorbisfile an Ogg file raises ``ValueError``."""
    path = str(path)
    if path.endswith(".npy"):
        x = np.load(path).astype(np.float32)
        if x.ndim == 1:
            x = x[:, None]
        sr = use_sample_rate or 16000
    else:
        data = Path(path).read_bytes()
        if data[:4] == b"fLaC":
            from mm_s2ut_torch.data.flac import decode_flac_bytes

            x, sr = decode_flac_bytes(data)
        elif data[:4] == b"OggS":
            from mm_s2ut_torch.data import ogg

            if not ogg.available():
                raise ValueError(
                    f"{path}: no libvorbisfile on this host; convert to wav "
                    "or flac offline (e.g. ffmpeg -i in.ogg -ar 16000 out.wav)"
                )
            x, sr = ogg.decode_ogg_bytes(data)
        else:
            x, sr = decode_wav_bytes(data)
    if x.shape[1] > 1:
        x = x.mean(axis=1, keepdims=True)
    if use_sample_rate is not None and sr != use_sample_rate:
        x = resample(x, sr, use_sample_rate)
        sr = use_sample_rate
    return x[:, 0], sr


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1,1] samples as 16-bit PCM WAV."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
