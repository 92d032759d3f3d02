"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded through ``ctypes`` — no
PyTorch headers, so a build takes seconds. Each ``.cu`` file compiles to
an object in its own ``nvcc`` process, all started together, and one
more ``nvcc`` links them. The library is built at first use into
``mm_s2ut_torch/_build/``, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code. Nothing here is imported or run
when the package is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# dtype codes of the C interface (csrc/common.cuh, enum DType).
F32, BF16 = 0, 1

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_d, _u32 = ctypes.c_double, ctypes.c_uint32
_FLASH = (
    [_i, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i] + [_i64] * 9
    + [_f, _i, _i, _d, _u32, _p, _p, _p],
    ctypes.c_int,
)
_SIGNATURES = {
    "mm_flash_attention": _FLASH,
    "mm_flash_attention_causal_skip": _FLASH,
    "mm_flash_attention_bwd": (
        [_i] + [_p] * 12 + [_i] * 5 + [_i64] * 9 + [_f, _i, _i, _d, _u32, _p],
        ctypes.c_int,
    ),
    "mm_ancestry_decode_splits": ([_i] * 5, ctypes.c_int),
    "mm_ancestry_decode_attention": (
        [_i, _i] + [_p] * 7 + [_i] * 7 + [_i64] * 16 + [_p],
        ctypes.c_int,
    ),
    "mm_cross_decode_smem_bytes": ([_i, _i, _i], ctypes.c_longlong),
    "mm_cross_decode_splits": ([_i] * 6, ctypes.c_int),
    "mm_cross_decode_attention": (
        [_i] + [_p] * 5 + [_i] * 6 + [_i64] * 6 + [_p],
        ctypes.c_int,
    ),
    "mm_ancestry_decode_i8_splits": ([_i] * 4, ctypes.c_int),
    "mm_ancestry_decode_i8_scratch_bytes": ([_i] * 6, ctypes.c_longlong),
    "mm_ancestry_decode_attention_i8": (
        [_i, _i] + [_p] * 9 + [_i] * 7 + [_i64] * 22 + [_p],
        ctypes.c_int,
    ),
    "mm_ancestry_decode_i4_smem_bytes": ([_i, _i, _i], ctypes.c_longlong),
    "mm_ancestry_decode_attention_i4": (
        [_i] + [_p] * 8 + [_i] * 6 + [_i64] * 10 + [_p],
        ctypes.c_int,
    ),
    "mm_cross_decode_attention_i8": (
        [_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
        ctypes.c_int,
    ),
}


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(csrc: Path = CSRC) -> Path:
    cu, cuh = _sources(csrc)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmm_s2ut_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc`` (the package's own by default)
    unless a library for these sources exists."""
    so = library_path(csrc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources(csrc)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in cu]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", obj, str(src)]
            for src, obj in zip(cu, objs)
        ])
        lib = os.path.join(tmp, so.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, so)  # atomic: a concurrent process never loads half a file
    return so


def _run_all(cmds) -> None:
    """Run the commands in parallel; wait for all, then raise on a failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    import torch

    if dtype == torch.float32:
        return F32
    if dtype == torch.bfloat16:
        return BF16
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
