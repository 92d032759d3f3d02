"""A restricted reader for PyTorch ``.pt`` checkpoints (zip format) that
returns numpy arrays and runs no code from the file.

A copy of ``mm_s2ut/utils/torch_pickle.py``. fairseq training checkpoints
pickle omegaconf configs, fairseq dataclasses and numpy scalars beside
the weights; ``torch.load(weights_only=True)`` refuses them and
``weights_only=False`` would run the file's own constructors. This reader
unpickles ``data.pkl`` itself:

* tensor rebuilds (``torch._utils._rebuild_tensor_v2`` /
  ``_rebuild_parameter``) become numpy arrays cut from the storage bytes
  by offset, size and stride, once the view is checked to lie inside the
  storage;
* storage dtypes map ``FloatStorage`` → f4 … ``BFloat16Storage`` → the
  uint16 bits widened to f32 (numpy has no bf16);
* a short list of stdlib and numpy globals (OrderedDict,
  argparse.Namespace, numpy scalars and dtypes, and ``_codecs.encode``,
  through which protocol 2 pickles bytes) resolve for real; every
  other class becomes an inert ``_Stub`` that keeps its pickled state in
  ``__dict__``, so config blobs stay readable and no third-party
  constructor runs.

Pre-1.6 (non-zip) files raise :class:`LegacyFormatError`;
:func:`load_checkpoint_numpy` then reads them with ``torch.load`` under
``weights_only=True``.
"""
from __future__ import annotations

import io
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

# torch storage class name → (numpy dtype, is_bfloat16)
_STORAGE_DTYPES: Dict[str, Tuple[np.dtype, bool]] = {
    "DoubleStorage": (np.dtype("<f8"), False),
    "FloatStorage": (np.dtype("<f4"), False),
    "HalfStorage": (np.dtype("<f2"), False),
    "BFloat16Storage": (np.dtype("<u2"), True),
    "LongStorage": (np.dtype("<i8"), False),
    "IntStorage": (np.dtype("<i4"), False),
    "ShortStorage": (np.dtype("<i2"), False),
    "CharStorage": (np.dtype("i1"), False),
    "ByteStorage": (np.dtype("u1"), False),
    "BoolStorage": (np.dtype("?"), False),
}

# dtype-tag objects produced for GLOBAL torch.FloatStorage etc.


class _StorageType:
    def __init__(self, name: str):
        self.name = name


class LegacyFormatError(ValueError):
    """The file is a pre-1.6 sequential-pickle torch checkpoint."""


class _Stub:
    """Inert stand-in for any non-allowlisted global: accepts any
    constructor arguments, absorbs ``__setstate__`` dicts into
    ``__dict__`` — never executes third-party code."""

    _qualname = "stub"

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2 and isinstance(state[0], (dict, type(None))):
            # (dict_state, slots_state) two-tuple convention
            self.__dict__.update(state[0] or {})
            if isinstance(state[1], dict):
                self.__dict__.update(state[1])
        else:
            self.__dict__["_state"] = state

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<stub {self._qualname} {sorted(self.__dict__)}>"


def _check_view(numel: int, storage_offset: int, size, stride) -> None:
    """Raise unless the view (offset, size, stride) lies inside a storage
    of ``numel`` elements: ``as_strided`` checks no bounds, so a crafted
    file could otherwise read memory past the storage."""
    if (len(size) != len(stride) or storage_offset < 0
            or any(s < 0 for s in size) or any(st < 0 for st in stride)):
        raise pickle.UnpicklingError(
            f"bad tensor view: offset {storage_offset}, size {size}, stride {stride}")
    if all(s > 0 for s in size):
        last = storage_offset + sum((s - 1) * st for s, st in zip(size, stride))
        if last >= numel:
            raise pickle.UnpicklingError(
                f"tensor view reaches element {last} of a storage of {numel}")
    elif storage_offset > numel:
        raise pickle.UnpicklingError(
            f"tensor view starts at {storage_offset}, past a storage of {numel}")


def _rebuild_tensor_v2(
    storage, storage_offset, size, stride, requires_grad=False,
    backward_hooks=None, metadata=None,
):
    arr, itemsize = storage
    storage_offset = int(storage_offset)
    size = tuple(int(s) for s in size)
    stride = tuple(int(s) for s in stride)
    _check_view(len(arr), storage_offset, size, stride)
    if not size:
        return arr[storage_offset].copy()
    base = arr[storage_offset:]
    strided = np.lib.stride_tricks.as_strided(
        base, size, tuple(s * itemsize for s in stride), writeable=False
    )
    return np.ascontiguousarray(strided)


def _rebuild_parameter(data, requires_grad=True, backward_hooks=None):
    return data


_SAFE_GLOBALS = {
    # Pickle protocol 2 (torch.save's) writes bytes as _codecs.encode(str,
    # "latin1"): a numpy scalar's payload comes through it. JAX's reader
    # lacks this entry, so a numpy scalar in a checkpoint fails there.
    ("_codecs", "encode"),
    ("collections", "OrderedDict"),
    ("argparse", "Namespace"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "complex"),
    ("builtins", "bytearray"),
    ("builtins", "list"),
    ("builtins", "dict"),
    ("builtins", "tuple"),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, data: io.BytesIO, load_storage):
        super().__init__(data)
        self._load_storage = load_storage

    def find_class(self, module: str, name: str):
        if module == "torch._utils" and name in (
            "_rebuild_tensor_v2", "_rebuild_tensor"
        ):
            return _rebuild_tensor_v2
        if module == "torch._utils" and name == "_rebuild_parameter":
            return _rebuild_parameter
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(name)
        if module == "torch.serialization" and name == "_get_layout":
            return lambda *a: None
        if module == "torch" and name in ("Size",):
            return tuple
        if (module, name) in _SAFE_GLOBALS:
            mod = __import__(module, fromlist=[name])
            return getattr(mod, name)
        stub = type(name, (_Stub,), {"_qualname": f"{module}.{name}"})
        return stub

    def persistent_load(self, saved_id):
        if not (isinstance(saved_id, tuple) and saved_id and saved_id[0] == "storage"):
            raise pickle.UnpicklingError(
                f"unsupported persistent id: {saved_id!r}"
            )
        _, storage_type, key, _location, numel = saved_id
        if isinstance(storage_type, _StorageType):
            type_name = storage_type.name
        else:  # torch ≥1.13 pickles torch.storage.TypedStorage + dtype stub
            type_name = getattr(storage_type, "_qualname", "").rsplit(".", 1)[-1]
        if type_name not in _STORAGE_DTYPES:
            raise pickle.UnpicklingError(
                f"unknown torch storage type {type_name!r}"
            )
        dtype, is_bf16 = _STORAGE_DTYPES[type_name]
        raw = self._load_storage(key)
        arr = np.frombuffer(raw, dtype=dtype, count=int(numel))
        if is_bf16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return (arr, arr.dtype.itemsize)


def load(path: str | Path) -> Any:
    """Read a torch zip-format ``.pt`` without torch. Tensors come back
    as ``np.ndarray`` (bf16 widened to f32); unknown pickled classes as
    inert attribute-bag stubs. Raises :class:`LegacyFormatError` for the
    pre-1.6 sequential format."""
    path = Path(path)
    if not zipfile.is_zipfile(path):
        raise LegacyFormatError(
            f"{path} is not a zip-format torch checkpoint (legacy "
            "pre-1.6 serialization needs torch to read)"
        )
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith("/data.pkl") or n == "data.pkl")
        root = pkl_name[: -len("data.pkl")]

        def load_storage(key: str) -> bytes:
            return zf.read(f"{root}data/{key}")

        data = io.BytesIO(zf.read(pkl_name))
        return _RestrictedUnpickler(data, load_storage).load()


def load_checkpoint_numpy(path: str | Path) -> Any:
    """The blob with every tensor as ``np.ndarray`` (bf16 widened to f32).
    Zip-format files go through :func:`load`; a legacy pre-1.6 file goes
    through ``torch.load(weights_only=True)``, which allows
    ``argparse.Namespace`` beside the tensors and refuses every other
    class."""
    try:
        return load(path)
    except LegacyFormatError:
        pass
    import argparse

    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)

    def conv(node):
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node

    return conv(blob)


def to_plain(node: Any) -> Any:
    """Best-effort conversion of a loaded blob to plain dicts: stubs →
    their ``__dict__`` (omegaconf DictConfig stubs → their ``_content``),
    so config blobs read uniformly whether they were pickled as plain
    dicts, Namespaces, or dataclasses."""
    if isinstance(node, _Stub):
        d = dict(node.__dict__)
        d.pop("_args", None)
        d.pop("_kwargs", None)
        if "_content" in d:  # omegaconf Container state
            return to_plain(d["_content"])
        return {k: to_plain(v) for k, v in d.items()}
    if isinstance(node, dict):
        return {k: to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(to_plain(v) for v in node)
    if hasattr(node, "__dict__") and type(node).__module__ == "argparse":
        return {k: to_plain(v) for k, v in vars(node).items()}
    return node
