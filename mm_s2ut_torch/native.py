"""ctypes bindings of the native audio loader (``csrc/audioio.cpp``).

Port of ``mm_s2ut/native``: the library is compiled with the host's C++
compiler at first use into ``mm_s2ut_torch/_build/``, named by a hash of
the source and flags (``-march=native`` is safe: it is built where it
runs). A build that fails raises; nothing falls back to the Python
decoder behind the caller's back. ``data/dataset.collate_native`` decides
where this loader applies.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Tuple

import numpy as np

from mm_s2ut_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "audioio.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmaudio_{h.hexdigest()[:16]}.so"


def build():
    """Compile the loader unless a library for this source exists."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH: cannot build the native "
                           "audio loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", out],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native audio loader build failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, so)  # atomic: a concurrent process never loads half a file
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.mm_decode_wav.restype = ctypes.c_int
    lib.mm_decode_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.mm_load_batch.restype = None
    lib.mm_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_int]
    return lib


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_wav(path: str, max_samples: int = 1 << 24) -> Tuple[np.ndarray, int]:
    """One wav → (float32 mono samples, sample rate)."""
    buf = np.zeros(max_samples, np.float32)
    sr = ctypes.c_int(0)
    n = library().mm_decode_wav(str(path).encode(), _float_ptr(buf), max_samples,
                                ctypes.byref(sr))
    if n < 0:
        raise IOError(f"native wav decode failed ({n}) for {path}")
    return buf[:n].copy(), sr.value


def load_batch(paths: List[str], max_samples: int,
               n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threaded batch decode → ((n, max_samples) zero-padded float32, (n,)
    lengths, (n,) sample rates); the GIL is released during the call."""
    lib = library()
    n = len(paths)
    out = np.empty((n, max_samples), np.float32)
    lengths = np.zeros(n, np.int32)
    rates = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.mm_load_batch(c_paths, n, _float_ptr(out), max_samples,
                      lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                      rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    bad = np.nonzero(lengths < 0)[0]
    if bad.size:
        raise IOError(f"native decode failed for {[paths[i] for i in bad[:3]]}")
    return out, lengths, rates
