"""The port's joblib reader (``mm_s2ut_torch/utils/joblib_pickle.py``)
against joblib and the JAX package: an sklearn ``MiniBatchKMeans`` fitted
on seeded frames and saved by ``joblib.dump`` (the reference's km1000
format) uncompressed and under zlib, gzip, bz2, lzma and xz loads through
the port's ``KMeansQuantizer.load`` with joblib and sklearn imports
blocked: centroids bit-equal to JAX's ``KMeansQuantizer.load`` (which reads
the file with joblib), units on seeded features equal to JAX's. A stream
naming numpy 1's ``numpy.core.multiarray`` and sklearn < 0.22's
``sklearn.cluster.k_means_``, Fortran-ordered, big-endian and object
arrays read as joblib reads them; a global outside the allow-list, lz4
and joblib < 0.10's side-car files raise, naming what they met."""
import ast
import builtins
import importlib
import io
import pickle
import warnings
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch
from sklearn.cluster import MiniBatchKMeans

from mm_s2ut.ops import kmeans as jk
from mm_s2ut_torch.ops import kmeans as tk
from mm_s2ut_torch.utils import joblib_pickle as jp

BLOCKED = ("joblib", "sklearn", "tensorflow", "tensorboard", "PIL", "jax", "mm_s2ut")
KMEANS = Path(__file__).resolve().parent / "torch_kmeans"


def write_kmeans_fixture(root: Path = KMEANS) -> None:
    """``km100.bin``: an sklearn ``MiniBatchKMeans`` of 100 centroids over
    768-wide seeded frames (HuBERT-base's width), saved by ``joblib.dump``
    with zlib as the reference saves its km1000; ``km100.npy`` its
    ``cluster_centers_``. ``chip_smoke.py`` phase 22a quantizes with both."""
    x = np.random.RandomState(22).randn(2000, 768).astype(np.float32)
    x += np.repeat(np.random.RandomState(23).randn(100, 768).astype(np.float32) * 3, 20, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        km = MiniBatchKMeans(n_clusters=100, random_state=0, n_init=1, batch_size=1024).fit(x)
    root.mkdir(parents=True, exist_ok=True)
    joblib.dump(km, root / "km100.bin", compress=("zlib", 1))
    np.save(root / "km100.npy", km.cluster_centers_)


def test_committed_kmeans_fixture_equals_jax_and_its_twin():
    """The fixture phase 22a reads on the card: the port's centroids equal
    JAX's (joblib's) and the ``.npy`` twin's, under 400 KB."""
    path = KMEANS / "km100.bin"
    assert path.stat().st_size < 400_000
    got = tk.KMeansQuantizer.load(path).centroids.numpy()
    assert got.shape == (100, 768)
    np.testing.assert_array_equal(got, np.asarray(jk.KMeansQuantizer.load(str(path)).centroids))
    np.testing.assert_array_equal(got, np.load(KMEANS / "km100.npy"))


@pytest.fixture(scope="module")
def km():
    x = np.random.RandomState(20).randn(600, 24).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return MiniBatchKMeans(n_clusters=12, random_state=0, n_init=3, batch_size=128).fit(x)


@pytest.fixture
def no_joblib(monkeypatch):
    """``import joblib`` / ``import sklearn...`` raise from here on."""
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name.split(".")[0] in ("joblib", "sklearn"):
            raise ImportError(f"{name} is blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", blocked)


COMPRESSIONS = [None, "zlib", "gzip", "bz2", "lzma", "xz"]


@pytest.mark.parametrize("compress", COMPRESSIONS)
def test_kmeans_file_equals_jax_without_joblib(compress, km, tmp_path, request):
    path = tmp_path / "km.bin"
    joblib.dump(km, path, compress=(compress, 3) if compress else 0)
    want = jk.KMeansQuantizer.load(str(path))
    feats = np.random.RandomState(21).randn(3, 40, 24).astype(np.float32)
    want_units = want(feats)
    request.getfixturevalue("no_joblib")
    with pytest.raises(ImportError):
        import joblib as _  # noqa: F401
    got = tk.KMeansQuantizer.load(path)
    assert got.centroids.dtype == torch.float32
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    np.testing.assert_array_equal(got.centroids.numpy(), km.cluster_centers_)
    np.testing.assert_array_equal(got(feats).numpy(), want_units)


def test_estimator_state_reads_as_joblib_reads_it(km, tmp_path):
    """Every attribute of the estimator, arrays and numpy scalars too."""
    joblib.dump(km, tmp_path / "km.bin", compress=3)
    got = jp.load(tmp_path / "km.bin")
    assert got._qualname == "sklearn.cluster._kmeans.MiniBatchKMeans"
    want = vars(joblib.load(tmp_path / "km.bin"))
    assert set(want) <= set(vars(got))
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert vars(got)[k].dtype == v.dtype, k
            np.testing.assert_array_equal(vars(got)[k], v, err_msg=k)
        else:
            assert vars(got)[k] == v, k


def _rename(data: bytes, pairs) -> bytes:
    for a, b in pairs:
        assert a in data, a
        data = data.replace(a, b)
    return data


def test_numpy1_and_old_sklearn_names(km, tmp_path):
    """Protocol 2 writes globals as text lines, so the stream can be made
    to name ``numpy.core.multiarray`` and ``sklearn.cluster.k_means_``
    (the fairseq-era km1000's names), which this sklearn cannot load."""
    buf = tmp_path / "p2.bin"
    joblib.dump({"km": km, "s": np.float64(2.5), "i": np.int32(-3)}, buf, protocol=2)
    data = buf.read_bytes()
    core = b"numpy._core.multiarray\n" if b"numpy._core.multiarray\n" in data \
        else b"numpy.core.multiarray\n"
    old = _rename(data, [(b"sklearn.cluster._kmeans\n", b"sklearn.cluster.k_means_\n"),
                         (core, b"numpy.core.multiarray\n")])
    (tmp_path / "old.bin").write_bytes(old)
    got = jp.load(tmp_path / "old.bin")
    assert got["km"]._qualname == "sklearn.cluster.k_means_.MiniBatchKMeans"
    np.testing.assert_array_equal(got["km"].cluster_centers_, km.cluster_centers_)
    assert got["s"] == 2.5 and type(got["s"]) is np.float64
    assert got["i"] == -3 and type(got["i"]) is np.int32
    joblib.dump(km, buf, protocol=2)
    (tmp_path / "old_km.bin").write_bytes(_rename(buf.read_bytes(), [
        (b"sklearn.cluster._kmeans\n", b"sklearn.cluster.k_means_\n")]))
    np.testing.assert_array_equal(tk.KMeansQuantizer.load(tmp_path / "old_km.bin")
                                  .centroids.numpy(), km.cluster_centers_)


def test_array_layouts_read_as_joblib_reads_them(tmp_path):
    """Fortran order, big-endian, 0-d, empty, object arrays (pickled inline),
    a RandomState, with and without joblib's alignment padding."""
    rng = np.random.RandomState(22)
    obj = {
        "f": np.asfortranarray(rng.randn(5, 7).astype(np.float32)),
        "be": rng.randint(-9, 9, (4, 3)).astype(">i4"),
        "zero_d": np.array(1.25),
        "empty": np.zeros((0, 3), np.int16),
        "objects": np.array(["a", 3, None], dtype=object),
        "rs": np.random.RandomState(5),
        "cf": (rng.randn(3) + 1j * rng.randn(3)).astype(np.complex64),
    }
    for protocol in (2, 4, 5):
        joblib.dump(obj, tmp_path / "a.bin", protocol=protocol)
        want = joblib.load(tmp_path / "a.bin")
        got = jp.load(tmp_path / "a.bin")
        for k in ("f", "be", "zero_d", "empty", "objects", "cf"):
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            assert got[k].dtype.isnative or got[k].dtype.kind == "O"
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["rs"].randint(1 << 30) == want["rs"].randint(1 << 30)


def test_global_outside_the_allow_list_raises(tmp_path):
    joblib.dump({"x": Path("a")}, tmp_path / "bad.bin")
    with pytest.raises(jp.JoblibFormatError, match=r"bad\.bin.*pathlib.*PosixPath"):
        jp.load(tmp_path / "bad.bin")
    (tmp_path / "os.bin").write_bytes(pickle.dumps(__import__("os").system, protocol=2))
    with pytest.raises(jp.JoblibFormatError, match=r"os\.bin.*(posix|os)\.system"):
        tk.KMeansQuantizer.load(tmp_path / "os.bin")


def test_lz4_and_old_joblib_files_raise(km, tmp_path):
    (tmp_path / "km.lz4.bin").write_bytes(b'\x04"M\x18' + bytes(40))
    with pytest.raises(jp.JoblibFormatError, match=r"km\.lz4\.bin.*lz4"):
        tk.KMeansQuantizer.load(tmp_path / "km.lz4.bin")
    (tmp_path / "zf.bin").write_bytes(b"ZF0x00000000000000a0" + bytes(20))
    with pytest.raises(jp.JoblibFormatError, match=r"zf\.bin.*0\.10"):
        jp.load(tmp_path / "zf.bin")
    # joblib < 0.10 kept each array in a side-car .npy named by an NDArrayWrapper
    side = (b"\x80\x02cjoblib.numpy_pickle\nNDArrayWrapper\nq\x00)\x81q\x01}q\x02"
            b"X\x08\x00\x00\x00filenameq\x03X\x0b\x00\x00\x00km.bin_01.npyq\x04sb.")
    (tmp_path / "old.bin").write_bytes(side)
    with pytest.raises(jp.JoblibFormatError, match=r"old\.bin.*side-car"):
        jp.load(tmp_path / "old.bin")
    with pytest.raises(jp.JoblibFormatError, match=r"no \(K, D\) cluster_centers_"):
        joblib.dump({"a": 1}, tmp_path / "d.bin")
        jp.load_kmeans_centroids(tmp_path / "d.bin")


def test_truncated_file_raises_naming_it(km, tmp_path):
    joblib.dump(km, tmp_path / "km.bin")
    data = (tmp_path / "km.bin").read_bytes()
    (tmp_path / "cut.bin").write_bytes(data[: len(data) // 2])
    with pytest.raises(jp.JoblibFormatError, match=r"cut\.bin"):
        jp.load(tmp_path / "cut.bin")
    (tmp_path / "cut.gz.bin").write_bytes(io.BytesIO(b"\x1f\x8b\x08\0garbage").read())
    with pytest.raises(jp.JoblibFormatError, match=r"cut\.gz\.bin.*gzip"):
        jp.load(tmp_path / "cut.gz.bin")


def imported_roots(module: str) -> set:
    path = (Path(__file__).resolve().parents[1] / "chip_smoke.py" if module == "chip_smoke"
            else Path(importlib.import_module(module).__file__))
    tree = ast.parse(path.read_text())
    return {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [ast.alias(n.module or "")])}


@pytest.mark.parametrize("module", ["mm_s2ut_torch.utils.joblib_pickle",
                                    "mm_s2ut_torch.ops.kmeans",
                                    "mm_s2ut_torch.train.metrics",
                                    "mm_s2ut_torch.data.tiff", "mm_s2ut_torch.data.ccitt",
                                    "mm_s2ut_torch.data.zstd", "mm_s2ut_torch.data.jpeg",
                                    "chip_smoke"])
def test_new_modules_import_no_third_party_reader(module):
    """joblib, sklearn, TensorFlow, TensorBoard, Pillow and JAX are absent
    on the card's machine: none of these modules (nor ``chip_smoke.py``)
    imports them, at any depth of the file."""
    assert not imported_roots(module) & set(BLOCKED), imported_roots(module)


if __name__ == "__main__":
    write_kmeans_fixture()
