"""The port's audio input against the JAX package's: FLAC decode and its
encoder, Ogg/Vorbis through libvorbisfile, ``get_waveform``'s dispatch,
and the native C++ loader (``mm_s2ut_torch/native.py`` built from
``mm_s2ut_torch/csrc/audioio.cpp``) with the dataset's ``collate_native``.
Every decode is held bit for bit: against JAX's decoder, and the native
loader against the Python decoder."""
import struct

import numpy as np
import pytest

from mm_s2ut.data import flac as j_flac
from mm_s2ut.data import ogg as j_ogg
from mm_s2ut.data.audio_io import get_waveform as j_get_waveform
from mm_s2ut_torch import native
from mm_s2ut_torch.data import flac as t_flac
from mm_s2ut_torch.data import ogg as t_ogg
from mm_s2ut_torch.data.audio_io import get_waveform, write_wav


def _sig(n, ch=1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)[:, None]
    x = 0.4 * np.sin(2 * np.pi * 440 * t / 16000.0 + np.arange(ch)) + 0.01 * rng.randn(n, ch)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


# (samples, channels, predictor order, block size): every fixed order,
# stereo, a short tail block, and 200 frames at block 160 (frame numbers
# past 127 take two UTF-8 bytes).
FLAC_CASES = [(5000, ch, order, 1024) for order in range(5) for ch in (1, 2)]
FLAC_CASES += [(1500, 1, 1, 1024), (200 * 160, 1, 2, 160), (3001, 2, 3, 1000)]


@pytest.mark.parametrize("n,ch,order,block", FLAC_CASES)
def test_flac_decode_equals_jax(n, ch, order, block):
    x = _sig(n, ch, seed=order + 10 * ch)
    blob = j_flac.encode_flac(x, 16000, order=order, block_size=block)
    assert t_flac.encode_flac(x, 16000, order=order, block_size=block) == blob
    got, sr = t_flac.decode_flac_bytes(blob)
    want, jsr = j_flac.decode_flac_bytes(blob)
    assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((got * 32768.0).round().astype(np.int64),
                                  x.astype(np.int64).reshape(n, ch))


def test_get_waveform_dispatches_flac_and_wav(tmp_path):
    x = _sig(4000, 2, seed=5)
    (tmp_path / "a.flac").write_bytes(t_flac.encode_flac(x, 8000, order=2))
    write_wav(tmp_path / "b.wav", x[:, 0] / 32768.0, 16000)
    for name, rate in (("a.flac", None), ("a.flac", 16000), ("b.wav", None)):
        got, sr = get_waveform(str(tmp_path / name), use_sample_rate=rate)
        want, jsr = j_get_waveform(str(tmp_path / name), use_sample_rate=rate)
        assert sr == jsr
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def vorbis():
    if not (t_ogg.available() and j_ogg.available()):
        pytest.skip("no libvorbisfile/libvorbisenc on this host")
    t_ogg._load_enc()


def test_ogg_round_trip_and_dispatch_equal_jax(tmp_path, vorbis):
    x = (_sig(16000, 2, seed=7) / 32768.0).astype(np.float32)
    blob = t_ogg.encode_ogg_bytes(x, 16000)
    got, sr = t_ogg.decode_ogg_bytes(blob)
    want, jsr = j_ogg.decode_ogg_bytes(blob)
    assert sr == jsr == 16000 and got.shape == want.shape == (16000, 2)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - x).mean() < 0.05  # lossy, but the same signal
    (tmp_path / "c.ogg").write_bytes(blob)
    got, sr = get_waveform(str(tmp_path / "c.ogg"))
    want, _ = j_get_waveform(str(tmp_path / "c.ogg"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(Exception):
        t_ogg.decode_ogg_bytes(b"OggS" + b"\x00" * 64)


def test_ogg_without_libvorbisfile_names_the_conversion(tmp_path, monkeypatch):
    (tmp_path / "d.ogg").write_bytes(b"OggS" + b"\x00" * 64)
    monkeypatch.setattr(t_ogg, "available", lambda: False)
    with pytest.raises(ValueError, match="no libvorbisfile.*ffmpeg"):
        get_waveform(str(tmp_path / "d.ogg"))


def _wav_bytes(fmt_code, channels, bits, sr, payload, extensible_sub=None):
    if extensible_sub is None:
        fmt = struct.pack("<HHIIHH", fmt_code, channels, sr, sr * channels * bits // 8,
                          channels * bits // 8, bits)
    else:
        guid = struct.pack("<H", extensible_sub) + bytes.fromhex("000000001000800000aa00389b71")
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * channels * bits // 8,
                          channels * bits // 8, bits, 22, bits, 0) + guid
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(riff)) + riff


def _wav_files(tmp_path):
    """A wav of each sample format the loaders read (mono and stereo)."""
    rng = np.random.RandomState(3)
    files = {}
    x16 = (rng.randn(1800, 2) * 6000).astype("<i2")
    files["pcm16_stereo"] = _wav_bytes(1, 2, 16, 16000, x16.tobytes())
    files["pcm16_mono"] = _wav_bytes(1, 1, 16, 16000, x16[:, 0].copy().tobytes())
    x32 = (rng.randn(900) * 2 ** 28).astype("<i4")
    files["pcm32"] = _wav_bytes(1, 1, 32, 16000, x32.tobytes())
    x8 = rng.randint(0, 256, 700).astype("u1")
    files["pcm8"] = _wav_bytes(1, 1, 8, 16000, x8.tobytes())
    x24 = rng.randint(0, 256, (1100, 3)).astype("u1")
    files["pcm24"] = _wav_bytes(1, 1, 24, 16000, x24.tobytes())
    xf = (rng.randn(1200) * 0.3).astype("<f4")
    files["float32"] = _wav_bytes(3, 1, 32, 16000, xf.tobytes())
    files["float32_extensible"] = _wav_bytes(0, 1, 32, 16000, xf.tobytes(), extensible_sub=3)
    files["pcm16_extensible"] = _wav_bytes(0, 1, 16, 16000, x16[:, 1].copy().tobytes(),
                                           extensible_sub=1)
    paths = {}
    for name, blob in files.items():
        paths[name] = tmp_path / f"{name}.wav"
        paths[name].write_bytes(blob)
    return paths


def test_native_decode_equals_the_python_decoder(tmp_path):
    from mm_s2ut import native as j_native

    paths = _wav_files(tmp_path)
    for name, path in paths.items():
        got, sr = native.decode_wav(str(path))
        want, jsr = j_native.decode_wav(str(path))
        assert sr == jsr == 16000, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        # The Python decoder reads every extensible file as PCM (as JAX's
        # does); the native one follows the SubFormat GUID.
        py, _ = get_waveform(str(paths[name.replace("_extensible", "")]
                                 if name == "float32_extensible" else path))
        np.testing.assert_array_equal(got, py, err_msg=name)
    names = sorted(paths)
    got, lens, rates = native.load_batch([str(paths[n]) for n in names], 2000, n_threads=3)
    for i, n in enumerate(names):
        want, _ = native.decode_wav(str(paths[n]))
        k = min(len(want), 2000)
        assert lens[i] == k and rates[i] == 16000
        np.testing.assert_array_equal(got[i, :k], want[:k], err_msg=n)
        assert not got[i, k:].any()


def test_native_decode_of_malformed_wavs(tmp_path):
    """A truncated file decodes the frames present, a lying data size the
    bytes present, bits_per_sample 0 is an error (not SIGFPE), and a batch
    with a bad file raises in Python."""
    rng = np.random.RandomState(2)
    x = (0.3 * rng.randn(2000)).astype(np.float32).clip(-1, 1)
    good = tmp_path / "good.wav"
    write_wav(good, x, 16000)
    raw = good.read_bytes()
    want, _ = get_waveform(str(good))
    (tmp_path / "trunc.wav").write_bytes(raw[: len(raw) - 1000])
    got, _ = native.decode_wav(str(tmp_path / "trunc.wav"))
    np.testing.assert_array_equal(got, want[:1500])
    lying = bytearray(raw)
    off = raw.index(b"data")
    lying[off + 4 : off + 8] = struct.pack("<I", 0xFFFFFFF0)
    (tmp_path / "lying.wav").write_bytes(bytes(lying))
    got, _ = native.decode_wav(str(tmp_path / "lying.wav"))
    np.testing.assert_array_equal(got, want)
    zbits = bytearray(raw)
    off = raw.index(b"fmt ")
    zbits[off + 22 : off + 24] = b"\x00\x00"
    (tmp_path / "zbits.wav").write_bytes(bytes(zbits))
    with pytest.raises(IOError):
        native.decode_wav(str(tmp_path / "zbits.wav"))
    with pytest.raises(IOError):
        native.load_batch([str(good), str(tmp_path / "zbits.wav")], 2500, n_threads=2)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A loader that cannot be built raises; nothing falls back quietly."""
    bad = tmp_path / "audioio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native audio loader build failed"):
            native.load_batch([str(bad)], 10)
    finally:
        native.library.cache_clear()


def _corpus(tmp_path, rates=(16000,) * 5, flac_rows=()):
    from mm_s2ut_torch.data.manifest import ManifestRow, write_manifest

    rng = np.random.RandomState(4)
    rows = []
    for i, sr in enumerate(rates):
        n = 2400 + 900 * ((i * 3) % 5)
        x = (0.3 * rng.randn(n)).astype(np.float32)
        name = f"{i + 1}.wav"
        if i in flac_rows:
            name = f"{i + 1}.flac"
            (tmp_path / name).write_bytes(t_flac.encode_flac(
                (np.clip(x, -1, 1) * 32767).astype(np.int16), sr))
        else:
            write_wav(tmp_path / name, x, sr)
        rows.append(ManifestRow(str(i), name, n, " ".join(map(str, rng.randint(0, 30, 4 + i))),
                                4 + i))
    write_manifest(tmp_path / "test.tsv", rows)


def _datasets(tmp_path):
    from mm_s2ut.config import DataConfig as JData
    from mm_s2ut.data.dataset import SpeechToSpeechDataset as JDataset
    from mm_s2ut.data.dictionary import UnitDictionary as JUnits
    from mm_s2ut_torch.config import DataConfig
    from mm_s2ut_torch.data.dataset import SpeechToSpeechDataset
    from mm_s2ut_torch.data.dictionary import UnitDictionary

    kw = dict(data_root=str(tmp_path), audio_root=str(tmp_path), target_code_size=36)
    t = SpeechToSpeechDataset.from_tsv(tmp_path, "test", DataConfig(**kw), UnitDictionary(36),
                                       is_train=False)
    j = JDataset.from_tsv(tmp_path, "test", JData(**kw), JUnits(36), is_train=False)
    return t, j


@pytest.mark.parametrize("indices", [[0, 1, 2, 3, 4], [4, 2, 0]])
def test_collate_native_equals_collate_and_jax(tmp_path, indices):
    _corpus(tmp_path)
    t, j = _datasets(tmp_path)
    S = 2400 + 900 * 4 + 100
    got = t.collate_native(indices, S, None, n_threads=2)
    py = t.collate([t[i] for i in indices], src_pad=S)
    want = j.collate_native(indices, S, None, n_threads=2)
    assert set(got) == set(py) and set(want) <= set(got)
    for key in got:
        np.testing.assert_array_equal(got[key], py[key], err_msg=key)
        assert got[key].dtype == py[key].dtype, key
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_collate_native_steps_aside_where_jax_does(tmp_path):
    """A non-wav source or a rate to resample → None (the Python collate
    then runs), as JAX's; noise mixing in training → None."""
    _corpus(tmp_path, flac_rows=(2,))
    t, j = _datasets(tmp_path)
    assert t.collate_native([0, 1], 6000, None) is not None
    assert t.collate_native([0, 2], 6000, None) is None
    assert j.collate_native([0, 2], 6000, None) is None
    (tmp_path / "3.flac").unlink()
    _corpus(tmp_path, rates=(16000, 8000, 16000, 16000, 16000))
    t, j = _datasets(tmp_path)
    assert t.collate_native([0, 1], 6000, None) is None
    assert j.collate_native([0, 1], 6000, None) is None
    t.is_train, t.noise_wavs, t.noise_cfg.noise_prob = True, [np.zeros(10, np.float32)], 0.5
    assert t.collate_native([0, 2], 6000, None) is None
