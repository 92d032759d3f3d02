"""The port's k-means unit quantizer (``mm_s2ut_torch/ops/kmeans.py``)
against the JAX package's on the same numpy inputs: distances and
assignments (fp32 1e-4; units equal except at near-ties, where the two
best distances differ by less than 1e-5 relative), Lloyd steps from the
same initial centroids (centroids and inertia per step within 1e-4), the
init's spread, ``decode`` greedy and beam, ``load`` (``.npy`` and the
reference's joblib file without joblib)/``save`` and ``dedup_units``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_s2ut.ops import kmeans as jk
from mm_s2ut_torch.ops import kmeans as tk

torch.set_num_threads(1)


def near_tie_rows(x: np.ndarray, c: np.ndarray, rel: float = 1e-5) -> np.ndarray:
    """Rows whose two nearest centroids' distances (float64) differ by
    less than ``rel`` of the nearest."""
    d = ((x.astype(np.float64)[:, None, :] - c.astype(np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) < rel * np.maximum(two[:, 0], 1e-12)


def assert_units_equal_but_near_ties(got, want, x, c):
    differ = np.asarray(got).reshape(-1) != np.asarray(want).reshape(-1)
    ties = near_tie_rows(x.reshape(-1, x.shape[-1]), c)
    assert not (differ & ~ties).any(), np.nonzero(differ & ~ties)


@pytest.mark.parametrize("n,d,k,scale", [(17, 5, 4, 1.0), (300, 64, 100, 1.0),
                                         (257, 768, 50, 4.0)])
def test_distances_and_assignment_match_jax(n, d, k, scale):
    rng = np.random.RandomState(n)
    x = (scale * rng.randn(n, d)).astype(np.float32)
    c = (scale * rng.randn(k, d)).astype(np.float32)
    got = tk.squared_distances(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(jk.squared_distances(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale ** 2 * d)
    units = tk.kmeans_assign(torch.from_numpy(x.reshape(n, 1, d)), torch.from_numpy(c))
    assert units.shape == (n, 1)
    assert_units_equal_but_near_ties(units.numpy(), jk.kmeans_assign(jnp.asarray(x),
                                                                     jnp.asarray(c)), x, c)


def test_assignment_near_ties_are_the_only_differences():
    """Rows placed on the bisector of two centroids: the packages may pick
    either, and the rule above accepts exactly those rows."""
    rng = np.random.RandomState(1)
    c = rng.randn(8, 16).astype(np.float32)
    mid = ((c[0] + c[1]) / 2)[None] + 1e-7 * rng.randn(20, 16).astype(np.float32)
    far = rng.randn(30, 16).astype(np.float32)
    x = np.concatenate([mid, far]).astype(np.float32)
    assert near_tie_rows(x, c)[:20].all() and not near_tie_rows(x, c)[20:].any()
    got = tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert set(got[:20].tolist()) <= {0, 1}
    assert_units_equal_but_near_ties(got, jk.kmeans_assign(jnp.asarray(x), jnp.asarray(c)), x, c)


def test_assignment_resolves_what_the_identity_cancels():
    """Frames close to their centroids beside large norms (‖x − c‖² about
    1e-6 of ‖x‖²): the GEMM identity's fp32 rounding exceeds the gaps
    between the nearest centroids and misassigns rows whose float64 gap is
    far from a tie; ``kmeans_assign`` re-ranks the identity's nearest by the
    differences and gives every row float64's nearest centroid."""
    rng = np.random.RandomState(3)
    base = 30.0 * rng.randn(1, 64)
    c = (base + 0.01 * rng.randn(6, 64)).astype(np.float32)
    x = (base + 0.01 * rng.randn(200, 64)).astype(np.float32)
    d64 = ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)
    want = d64.argmin(-1)
    assert not near_tie_rows(x, c).any()
    ident = tk.squared_distances(torch.from_numpy(x), torch.from_numpy(c)).argmin(-1).numpy()
    assert (ident != want).sum() > 10
    got = tk.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_steps", [1, 6])
def test_kmeans_fit_matches_jax_from_the_same_init(n_steps):
    rng = np.random.RandomState(2)
    centers = 4.0 * rng.randn(6, 12)
    x = np.concatenate([c + rng.randn(60, 12) for c in centers]).astype(np.float32)
    # Eight centroids for six clusters, one of them far away: it stays empty
    # and keeps its place in both packages.
    init = np.concatenate([x[rng.choice(len(x), 7, replace=False)],
                           np.full((1, 12), 100.0, np.float32)])
    got_c, got_i = tk.kmeans_fit(torch.from_numpy(x), torch.from_numpy(init), n_steps)
    want_c, want_i = jk.kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(init),
                                   n_steps=n_steps)
    assert got_i.shape == (n_steps,)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-4)
    np.testing.assert_array_equal(got_c.numpy()[-1], init[-1])
    assert float(got_i[-1]) <= float(got_i[0])


def test_kmeans_plusplus_init_spreads():
    """The init puts a centroid in every cluster, the one at the origin
    included (JAX's regression test of its placeholder rows), and draws
    reproducibly from its generator."""
    rng = np.random.RandomState(0)
    centers = np.array([[0, 0], [8, 0], [-8, 0]], np.float32)
    x = np.concatenate([c + 0.1 * rng.randn(80, 2) for c in centers]).astype(np.float32)
    for seed in range(4):
        init = tk.kmeans_plusplus_init(torch.from_numpy(x), 3,
                                       torch.Generator().manual_seed(seed)).numpy()
        d = np.sqrt(((init[:, None] - centers[None]) ** 2).sum(-1))
        assert (d.min(axis=0) < 1.0).all(), d
        again = tk.kmeans_plusplus_init(torch.from_numpy(x), 3,
                                        torch.Generator().manual_seed(seed)).numpy()
        np.testing.assert_array_equal(init, again)
    few = tk.kmeans_plusplus_init(torch.from_numpy(x[:5]), 3, torch.Generator().manual_seed(0))
    assert few.shape == (3, 2)  # fewer rows than candidates: drawn with replacement
    cents, inertia = tk.kmeans_fit(torch.from_numpy(x), torch.from_numpy(init), 10)
    d = np.sqrt(((cents.numpy()[:, None] - centers[None]) ** 2).sum(-1))
    assert (d.min(axis=0) < 0.2).all()


@pytest.mark.parametrize("beam", [False, True])
def test_decode_matches_jax(beam):
    rng = np.random.RandomState(3)
    c = rng.randn(10, 8).astype(np.float32)
    x = (c[rng.randint(0, 10, 14)] + 0.8 * rng.randn(14, 8)).astype(np.float32)
    got = tk.KMeansQuantizer(c).decode(x, beamsearch=beam, top_k=3, beamsize=8)
    want = jk.KMeansQuantizer(c).decode(x, beamsearch=beam, top_k=3, beamsize=8)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["code"], want["code"])
    assert got["merged_code"] == want["merged_code"] == tk.dedup_units(got["code"])
    np.testing.assert_allclose(got["distance"], want["distance"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["center_diff"], want["center_diff"], atol=1e-6)
    if beam:
        np.testing.assert_array_equal(got["beam_code"], want["beam_code"])
        assert got["beam_merged_code"] == want["beam_merged_code"]


def test_quantizer_load_save_and_call(tmp_path):
    rng = np.random.RandomState(4)
    c = rng.randn(12, 6).astype(np.float32)
    np.save(tmp_path / "km.npy", c)
    np.savez(tmp_path / "km.npz", centroids=c)
    x = rng.randn(5, 7, 6).astype(np.float32)
    want = np.asarray(jk.KMeansQuantizer.load(str(tmp_path / "km.npy"))(x))
    for name in ("km.npy", "km.npz"):
        q = tk.KMeansQuantizer.load(tmp_path / name)
        assert q.n_units == 12
        units = q(x)
        assert isinstance(units, torch.Tensor) and units.shape == (5, 7)
        assert_units_equal_but_near_ties(units.numpy(), want, x, c)
        assert_units_equal_but_near_ties(q(torch.from_numpy(x)).numpy(), want, x, c)
    q.save(tmp_path / "again.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "again.npy"), c)


def test_quantizer_assigns_on_the_features_device():
    """The quantizer has no device of its own: units come back on the
    features' device (here the meta device, which runs no arithmetic),
    with the centroids copied there once."""
    q = tk.KMeansQuantizer(np.random.RandomState(6).randn(12, 6).astype(np.float32))
    units = q(torch.empty(5, 7, 6, device="meta"))
    assert units.device.type == "meta" and units.shape == (5, 7) and units.dtype == torch.int64
    meta = q.centroids_on(torch.device("meta"))
    assert q.centroids_on(torch.device("meta")) is meta and meta.device.type == "meta"
    assert q.centroids_on(torch.device("cpu")) is q.centroids


def test_joblib_quantizer_without_joblib_names_npy(tmp_path, monkeypatch):
    """Without joblib or sklearn the quantizer still reads the reference's
    ``joblib.dump`` of an sklearn k-means, equal to its ``.npy`` twin (the
    file a user once had to write by hand)."""
    import builtins
    import warnings

    import joblib
    from sklearn.cluster import MiniBatchKMeans

    x = np.random.RandomState(7).randn(200, 6).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        km = MiniBatchKMeans(n_clusters=5, random_state=0, n_init=3).fit(x)
    joblib.dump(km, tmp_path / "km.bin")
    np.save(tmp_path / "km.npy", km.cluster_centers_)
    real_import = builtins.__import__

    def no_joblib(name, *args, **kwargs):
        if name.split(".")[0] in ("joblib", "sklearn"):
            raise ImportError(f"no {name}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_joblib)
    got = tk.KMeansQuantizer.load(tmp_path / "km.bin")
    want = tk.KMeansQuantizer.load(tmp_path / "km.npy")
    np.testing.assert_array_equal(got.centroids.numpy(), want.centroids.numpy())
    np.testing.assert_array_equal(got(x).numpy(), want(x).numpy())


def test_dedup_units():
    assert tk.dedup_units([1, 1, 2, 2, 2, 1, 3, 3]) == jk.dedup_units([1, 1, 2, 2, 2, 1, 3, 3])
    assert tk.dedup_units(np.array([5, 5, 5])) == [5] and tk.dedup_units([]) == []
