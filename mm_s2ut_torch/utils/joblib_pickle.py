"""A restricted reader for ``joblib.dump`` files that runs no code from the
file and needs neither joblib nor sklearn.

The reference quantizes HuBERT features with an sklearn ``MiniBatchKMeans``
saved by ``joblib.dump`` (the km1000 ``.bin`` of ``3_cluster.sh``). This
reader unpickles such a file the way joblib's ``NumpyUnpickler`` does:

* the whole file may be one zlib, gzip, bz2, lzma or xz stream, detected by
  its first bytes as joblib detects it, and is decompressed with the
  standard library; lz4 and joblib < 0.10's files (the ``ZF`` prefix, or
  arrays kept in side-car ``.npy`` files) raise, naming the file;
* ``joblib.numpy_pickle.NumpyArrayWrapper`` becomes the array whose bytes
  follow its BUILD opcode in the stream (after the alignment padding of
  joblib >= 1.2, or as a nested pickle for an object array);
* numpy's ``dtype``, ``ndarray``, ``scalar``, ``_reconstruct`` and the
  RandomState / bit-generator constructors resolve for real, under both
  the ``numpy.core.*`` names of numpy 1 and the ``numpy._core.*`` names of
  numpy 2;
* every global under ``sklearn.`` becomes an inert stub that keeps its
  pickled state in ``__dict__`` (``torch_pickle._Stub``), so
  ``sklearn.cluster.k_means_`` (sklearn < 0.22) reads like
  ``sklearn.cluster._kmeans``;
* any other global raises :class:`JoblibFormatError`, naming it.

:func:`load_kmeans_centroids` gives a k-means file's ``cluster_centers_``.
"""
from __future__ import annotations

import bz2
import gzip
import importlib
import io
import lzma
import pickle
import zlib
from pathlib import Path
from typing import Any, Callable

import numpy as np

from mm_s2ut_torch.utils.torch_pickle import _Stub


class JoblibFormatError(ValueError):
    """The file is not one this reader takes (named in the message)."""


def _zlib(data: bytes) -> bytes:
    return zlib.decompress(data)


# joblib's compressors by their first bytes (joblib.compressor._COMPRESSORS)
_CODECS: list[tuple[bytes, str, Callable[[bytes], bytes] | None]] = [
    (b"x", "zlib", _zlib),
    (b"\x1f\x8b", "gzip", gzip.decompress),
    (b"BZ", "bz2", bz2.decompress),
    (b"]\x00", "lzma", lambda d: lzma.decompress(d, format=lzma.FORMAT_ALONE)),
    (b"\xfd7zXZ", "xz", lambda d: lzma.decompress(d, format=lzma.FORMAT_XZ)),
    (b'\x04"M\x18', "lz4", None),
]


def _decompressed(data: bytes, name: str) -> bytes:
    if data.startswith(b"ZF"):
        raise JoblibFormatError(f"{name}: a joblib < 0.10 compressed file (ZF prefix), which "
                                "this reader does not take")
    for prefix, codec, fn in _CODECS:
        if data.startswith(prefix):
            if fn is None:
                raise JoblibFormatError(f"{name}: {codec}-compressed joblib file; {codec} is "
                                        "not in the standard library, so this reader does not "
                                        "take it")
            try:
                return fn(data)
            except (OSError, EOFError, ValueError, lzma.LZMAError, zlib.error) as e:
                raise JoblibFormatError(f"{name}: bad {codec} stream ({e})") from None
    return data


def _np_core(sub: str):
    """``numpy._core.{sub}`` (numpy 2), else ``numpy.core.{sub}``."""
    try:
        return importlib.import_module(f"numpy._core.{sub}")
    except ImportError:
        return importlib.import_module(f"numpy.core.{sub}")


def _np_random(name: str):
    pickle_mod = importlib.import_module("numpy.random._pickle")
    return getattr(pickle_mod, name)


_NUMPY: dict[tuple[str, str], Callable[[], Any]] = {
    ("numpy", "ndarray"): lambda: np.ndarray,
    ("numpy", "memmap"): lambda: np.ndarray,
    ("numpy", "dtype"): lambda: np.dtype,
    **{(f"numpy.{core}.multiarray", n): (lambda n=n: getattr(_np_core("multiarray"), n))
       for core in ("core", "_core") for n in ("_reconstruct", "scalar")},
    **{(f"numpy.{core}.numeric", "_frombuffer"): (lambda: _np_core("numeric")._frombuffer)
       for core in ("core", "_core")},
    ("numpy.random", "__RandomState_ctor"): lambda: _np_random("__randomstate_ctor"),
    **{("numpy.random._pickle", n): (lambda n=n: _np_random(n))
       for n in ("__randomstate_ctor", "__bit_generator_ctor", "__generator_ctor")},
    **{(f"numpy.random.{m}", c): (lambda m=m, c=c: getattr(
        importlib.import_module(f"numpy.random.{m}"), c))
       for m, c in (("_mt19937", "MT19937"), ("_pcg64", "PCG64"), ("_pcg64", "PCG64DXSM"),
                    ("_philox", "Philox"), ("_sfc64", "SFC64"))},
}
_BUILTINS = {("_codecs", "encode"), ("collections", "OrderedDict"), ("builtins", "set"),
             ("builtins", "frozenset"), ("builtins", "complex"), ("builtins", "bytearray"),
             ("builtins", "list"), ("builtins", "dict"), ("builtins", "tuple"),
             ("builtins", "slice")}


class _ArrayWrapper(_Stub):
    """``NumpyArrayWrapper``: its state says what array follows it."""

    _qualname = "joblib.numpy_pickle.NumpyArrayWrapper"

    def read(self, unpickler: "_JoblibUnpickler") -> np.ndarray:
        f = unpickler.file_handle
        dtype, shape, order = self.dtype, tuple(int(s) for s in self.shape), self.order
        if not isinstance(dtype, np.dtype):
            raise JoblibFormatError(f"{unpickler.name}: array wrapper without a numpy dtype")
        if dtype.hasobject:  # pickled inline with the default pickler's protocol
            return _JoblibUnpickler(f, unpickler.name).load()
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            pad = f.read(1)
            if len(pad) != 1:
                raise JoblibFormatError(f"{unpickler.name}: stream ends before an array")
            f.read(pad[0])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        raw = f.read(count * dtype.itemsize)
        if len(raw) != count * dtype.itemsize:
            raise JoblibFormatError(f"{unpickler.name}: stream ends inside an array of "
                                    f"{count} {dtype} values")
        arr = np.frombuffer(raw, dtype, count).copy()
        arr = arr.reshape(shape[::-1]).T if order == "F" else arr.reshape(shape)
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr


class _JoblibUnpickler(pickle._Unpickler):
    """joblib's ``NumpyUnpickler`` (the pure-Python unpickler, so that the
    array bytes are read from the stream right after their wrapper)."""

    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, f: io.BytesIO, name: str):
        super().__init__(f)
        self.file_handle = f
        self.name = name

    def find_class(self, module: str, name: str):
        if (module, name) == ("joblib.numpy_pickle", "NumpyArrayWrapper"):
            return _ArrayWrapper
        if module.startswith("joblib") and name in ("NDArrayWrapper", "ZNDArrayWrapper"):
            raise JoblibFormatError(f"{self.name}: a joblib < 0.10 file whose arrays lie in "
                                    f"side-car .npy files ({module}.{name}), which this reader "
                                    "does not take")
        if (module, name) in _NUMPY:
            return _NUMPY[(module, name)]()
        if (module, name) in _BUILTINS:
            return getattr(importlib.import_module(module), name)
        if module == "sklearn" or module.startswith("sklearn."):
            return type(name, (_Stub,), {"_qualname": f"{module}.{name}"})
        raise JoblibFormatError(f"{self.name}: global {module}.{name} is not one this reader "
                                "resolves")

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self))

    dispatch[pickle.BUILD[0]] = load_build


def load(path: str | Path) -> Any:
    """The object in a ``joblib.dump`` file, arrays as ``np.ndarray`` and
    sklearn estimators as stubs holding their state."""
    name = str(path)
    data = _decompressed(Path(path).read_bytes(), name)
    try:
        return _JoblibUnpickler(io.BytesIO(data), name).load()
    except (pickle.UnpicklingError, EOFError) as e:
        raise JoblibFormatError(f"{name}: not a joblib pickle ({e})") from None


def load_kmeans_centroids(path: str | Path) -> np.ndarray:
    """A joblib k-means file's ``cluster_centers_`` (K, D) as float32."""
    km = load(path)
    centers = getattr(km, "cluster_centers_", None)
    if not isinstance(centers, np.ndarray) or centers.ndim != 2:
        raise JoblibFormatError(f"{path}: no (K, D) cluster_centers_ array in "
                                f"{getattr(km, '_qualname', type(km).__name__)}")
    return np.asarray(centers, np.float32)
