"""Ogg/Vorbis decode (and encode, for tests) through the system's
libvorbisfile / libvorbisenc, bound with ctypes.

A copy of ``mm_s2ut/data/ogg.py``. Decoding goes through in-memory
``ov_open_callbacks``, so zip-sliced byte buffers need no temporary file.
Without the library :func:`available` is false and
``data/audio_io.get_waveform`` raises, naming the conversion to wav.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_READ_CB = ctypes.CFUNCTYPE(
    ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
    ctypes.c_void_p,
)
_SEEK_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
)
_CLOSE_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)
_TELL_CB = ctypes.CFUNCTYPE(ctypes.c_long, ctypes.c_void_p)


class _OvCallbacks(ctypes.Structure):
    _fields_ = [
        ("read_func", _READ_CB),
        ("seek_func", _SEEK_CB),
        ("close_func", _CLOSE_CB),
        ("tell_func", _TELL_CB),
    ]


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        # remaining fields unused
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("vorbisfile") or "libvorbisfile.so.3"
        lib = ctypes.CDLL(name)
        lib.ov_open_callbacks.restype = ctypes.c_int
        lib.ov_open_callbacks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            _OvCallbacks,
        ]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_read.restype = ctypes.c_long
        lib.ov_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_clear.restype = ctypes.c_int
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def decode_ogg_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """ogg/vorbis bytes → ((T, C) float32 in [-1, 1], sample_rate)."""
    lib = _load()
    pos = [0]
    buf = data

    @_READ_CB
    def read_cb(ptr, size, nmemb, _source):
        want = size * nmemb
        chunk = buf[pos[0]: pos[0] + want]
        pos[0] += len(chunk)
        if chunk:
            ctypes.memmove(ptr, chunk, len(chunk))
        return len(chunk) // size if size else 0

    @_SEEK_CB
    def seek_cb(_source, offset, whence):
        if whence == 0:
            pos[0] = offset
        elif whence == 1:
            pos[0] += offset
        else:
            pos[0] = len(buf) + offset
        pos[0] = max(0, min(pos[0], len(buf)))
        return 0

    @_CLOSE_CB
    def close_cb(_source):
        return 0

    @_TELL_CB
    def tell_cb(_source):
        return pos[0]

    callbacks = _OvCallbacks(read_cb, seek_cb, close_cb, tell_cb)
    # OggVorbis_File is ~940 bytes on LP64; over-allocate for safety.
    ovf = ctypes.create_string_buffer(8192)
    # datasource must be non-NULL: libvorbisfile short-circuits a NULL
    # datasource before ever invoking the callbacks (state lives in the
    # Python closure, so the pointer value itself is unused).
    rc = lib.ov_open_callbacks(ctypes.c_void_p(1), ovf, None, 0, callbacks)
    if rc != 0:
        raise ValueError(f"libvorbisfile: ov_open_callbacks failed (rc={rc})")
    try:
        info = lib.ov_info(ovf, -1).contents
        channels, rate = info.channels, int(info.rate)
        out = bytearray()
        chunk = ctypes.create_string_buffer(65536)
        bitstream = ctypes.c_int(0)
        OV_HOLE = -3  # interruption in the data — recoverable, skip
        holes = 0
        while True:
            n = lib.ov_read(
                ovf, chunk, len(chunk), 0, 2, 1, ctypes.byref(bitstream)
            )
            if n == 0:
                break
            if n < 0:
                # Only OV_HOLE advances the stream on retry; any other
                # negative code (OV_EBADLINK/OV_EINVAL/...) repeats
                # forever on a corrupt or truncated stream — raise, and
                # bound even the hole retries defensively.
                holes += 1
                if n != OV_HOLE or holes > 10000:
                    raise ValueError(
                        f"libvorbisfile: ov_read failed (rc={n}) — "
                        "corrupt or truncated ogg stream"
                    )
                continue
            out += chunk.raw[:n]
    finally:
        lib.ov_clear(ovf)
    pcm = np.frombuffer(bytes(out), dtype="<i2").astype(np.float32) / 32768.0
    if channels > 1:
        pcm = pcm.reshape(-1, channels)
    else:
        pcm = pcm[:, None]
    return pcm, rate


# ---------------------------------------------------------------------------
# encoding (libvorbisenc) — used by data-prep and the round-trip tests
# ---------------------------------------------------------------------------


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_longlong),
        ("packetno", ctypes.c_longlong),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


def _load_enc():
    name = ctypes.util.find_library("vorbisenc") or "libvorbisenc.so.2"
    venc = ctypes.CDLL(name)
    vorbis = ctypes.CDLL(ctypes.util.find_library("vorbis") or "libvorbis.so.0")
    ogglib = ctypes.CDLL(ctypes.util.find_library("ogg") or "libogg.so.0")
    vorbis.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float)
    )
    return venc, vorbis, ogglib


def encode_ogg_bytes(wav, sample_rate: int, quality: float = 0.4) -> bytes:
    """(T,) or (T, C) float32 in [-1, 1] → ogg/vorbis bytes."""
    venc, vorbis, ogglib = _load_enc()
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[:, None]
    T, C = wav.shape

    vi = ctypes.create_string_buffer(8192)
    vorbis.vorbis_info_init(vi)
    if venc.vorbis_encode_init_vbr(
        vi, ctypes.c_long(C), ctypes.c_long(sample_rate),
        ctypes.c_float(quality),
    ) != 0:
        raise ValueError("vorbis_encode_init_vbr failed")
    vc = ctypes.create_string_buffer(8192)
    vorbis.vorbis_comment_init(vc)
    vd = ctypes.create_string_buffer(32768)
    vb = ctypes.create_string_buffer(32768)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    os_ = ctypes.create_string_buffer(32768)
    ogglib.ogg_stream_init(os_, 1)

    out = bytearray()
    page = _OggPage()

    def drain(force: bool):
        while True:
            fn = ogglib.ogg_stream_flush if force else ogglib.ogg_stream_pageout
            if fn(os_, ctypes.byref(page)) == 0:
                break
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    hdr = _OggPacket()
    hdr_comm = _OggPacket()
    hdr_code = _OggPacket()
    vorbis.vorbis_analysis_headerout(
        vd, vc, ctypes.byref(hdr), ctypes.byref(hdr_comm), ctypes.byref(hdr_code)
    )
    for p in (hdr, hdr_comm, hdr_code):
        ogglib.ogg_stream_packetin(os_, ctypes.byref(p))
    drain(True)

    pkt = _OggPacket()
    CHUNK = 4096
    i = 0
    while True:
        n = min(CHUNK, T - i)
        if n > 0:
            bufpp = vorbis.vorbis_analysis_buffer(vd, ctypes.c_int(n))
            for c in range(C):
                # Bind the contiguous copy to a name: `.ctypes.data` does
                # NOT keep a temporary alive, so inlining it frees the
                # buffer before memmove reads it (flaky corrupt channels).
                col = np.ascontiguousarray(wav[i:i + n, c])
                ctypes.memmove(bufpp[c], col.ctypes.data, n * 4)
                del col
            vorbis.vorbis_analysis_wrote(vd, ctypes.c_int(n))
            i += n
        else:
            vorbis.vorbis_analysis_wrote(vd, 0)  # end of stream
        while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
            vorbis.vorbis_analysis(vb, None)
            vorbis.vorbis_bitrate_addblock(vb)
            while vorbis.vorbis_bitrate_flushpacket(vd, ctypes.byref(pkt)) == 1:
                ogglib.ogg_stream_packetin(os_, ctypes.byref(pkt))
                drain(False)
        if n == 0:
            break
    drain(True)
    ogglib.ogg_stream_clear(os_)
    vorbis.vorbis_block_clear(vb)
    vorbis.vorbis_dsp_clear(vd)
    vorbis.vorbis_comment_clear(vc)
    vorbis.vorbis_info_clear(vi)
    return bytes(out)
