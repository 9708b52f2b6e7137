"""The port's data extras against the JAX package: ``FeatureSet.from_ndarrays``,
the ``keras.datasets`` loaders (the offline stand-ins bit for bit, given
the same arguments, and the local-file layouts) and the 3D image
transforms of ``data/image3d.py`` (the cases of ``tests/test_image3d.py``,
each run by both packages on the same volume and compared bit for bit).
"""

import numpy as np
import pytest

from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.data import image3d as j3d
from analytics_zoo_tpu.data import image_set as jis
from analytics_zoo_tpu.keras import datasets as jds
from analytics_zoo_tpu_torch import data as tdata
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import image3d as t3d
from analytics_zoo_tpu_torch.data import image_set as tis
from analytics_zoo_tpu_torch.keras import datasets as tds


def _equal(a, b):
    """Nested tuples of arrays (object arrays of lists included)."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        assert [list(s) for s in a] == [list(s) for s in b]
    else:
        np.testing.assert_array_equal(a, b)


def test_from_ndarrays_matches_jax():
    rng = np.random.default_rng(0)
    x = [rng.random((10, 3), dtype=np.float32), rng.integers(0, 5, (10, 2))]
    y = rng.integers(0, 2, 10)
    for args in ((x, y), (x[0], None), (x[0], [y, y])):
        t = tfs.ArrayFeatureSet.from_ndarrays(*args)
        j = jfs.ArrayFeatureSet.from_ndarrays(*args)
        assert isinstance(t, tfs.ArrayFeatureSet)
        assert t.num_samples == j.num_samples == 10
        idx = np.array([3, 0, 7])
        for a, b in zip(t.take(idx), j.take(idx)):
            if a is None:
                assert b is None
                continue
            for u, v in zip(a if isinstance(a, list) else [a],
                            b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(u, v)


STANDINS = [
    ("mnist", {}), ("mnist", {"n_synth": 100, "seed": 3}),
    ("imdb", {}), ("imdb", {"num_words": 800, "maxlen": 30, "seed": 2}),
    ("boston_housing", {}), ("boston_housing", {"test_split": 0.5,
                                                "seed": 1}),
    ("reuters", {}), ("reuters", {"num_words": 900, "maxlen": 40}),
]


@pytest.mark.parametrize("name,kw", STANDINS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(STANDINS)])
def test_dataset_standins_are_bitwise_the_jax_ones(name, kw):
    _equal(getattr(tds, name).load_data(**kw),
           getattr(jds, name).load_data(**kw))


def test_dataset_helpers_and_local_files(tmp_path):
    assert tds.imdb.get_word_index() == jds.imdb.get_word_index()
    seqs = [[1, 2, 3], [4], list(range(10))]
    np.testing.assert_array_equal(tds.imdb.pad_sequences(seqs, 5, value=9),
                                  jds.imdb.pad_sequences(seqs, 5, value=9))
    assert tds.reuters.NB_CLASSES == 46
    rng = np.random.default_rng(1)
    mn = tmp_path / "mnist.npz"
    np.savez(mn, x_train=rng.integers(0, 255, (6, 28, 28), np.uint8),
             y_train=np.arange(6), x_test=np.zeros((2, 28, 28), np.uint8),
             y_test=np.arange(2))
    _equal(tds.mnist.load_data(str(mn)), jds.mnist.load_data(str(mn)))
    seq = np.empty(4, dtype=object)
    seq[:] = [[1, 6000, 3], [2] * 50, [7, 8], [9]]
    im = tmp_path / "imdb.npz"
    np.savez(im, x_train=seq, y_train=np.arange(4), x_test=seq,
             y_test=np.arange(4))
    _equal(tds.imdb.load_data(str(im), maxlen=10),
           jds.imdb.load_data(str(im), maxlen=10))
    bh = tmp_path / "bh.npz"
    np.savez(bh, x=rng.random((10, 13)), y=rng.random(10))
    _equal(tds.boston_housing.load_data(str(bh)),
           jds.boston_housing.load_data(str(bh)))
    rt = tmp_path / "reuters.npz"
    np.savez(rt, x=seq, y=np.arange(4))
    _equal(tds.reuters.load_data(str(rt), num_words=100),
           jds.reuters.load_data(str(rt), num_words=100))
    with pytest.raises(ValueError, match="502"):
        tds.imdb.load_data(num_words=100)


def _vol(d=8, h=10, w=12, seed=0):
    return np.random.default_rng(seed).normal(size=(d, h, w)).astype(
        np.float32)


def _grid():
    zz, yy, xx = np.meshgrid(np.arange(5), np.arange(5), np.arange(5),
                             indexing="ij")
    return np.stack([zz, yy, xx]).astype(np.float64)


VOLUME_CASES = {
    "crop3d": (lambda m: m.Crop3D((1, 2, 3), (4, 5, 6)), _vol()),
    "center_crop": (lambda m: m.CenterCrop3D(4, 4, 4), _vol()),
    "random_crop": (lambda m: m.RandomCrop3D(
        3, 5, 7, rng=np.random.default_rng(1)), _vol()),
    "affine_identity": (lambda m: m.AffineTransform3D(np.eye(3)), _vol()),
    "affine_shear": (lambda m: m.AffineTransform3D(
        np.array([[1.0, 0.2, 0.0], [0.0, 0.9, 0.1], [0.05, 0.0, 1.1]]),
        translation=(0.5, -1.0, 2.0)), _vol()),
    "rotate_full_turn": (lambda m: m.Rotate3D((2 * np.pi, 0, 0)),
                         _vol(8, 8, 8)),
    "rotate_half_turn": (lambda m: m.Rotate3D((np.pi, 0, 0)),
                         _vol(4, 6, 6)),
    "rotate_mixed": (lambda m: m.Rotate3D((0.3, -0.7, 1.1)), _vol(6, 7, 8)),
    "padding": (lambda m: m.AffineTransform3D(
        np.eye(3), translation=(10, 0, 0), clamp_mode="padding",
        pad_val=-7.0), np.ones((4, 4, 4), np.float32)),
    "clamp": (lambda m: m.AffineTransform3D(np.eye(3),
                                            translation=(10, 0, 0)),
              np.ones((4, 4, 4), np.float32)),
}


@pytest.mark.parametrize("case", sorted(VOLUME_CASES))
def test_image3d_volume_transforms_match_jax(case):
    make, v = VOLUME_CASES[case]
    got = make(t3d).transform_volume(v.copy())
    want = make(j3d).transform_volume(v.copy())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_image3d_features_warp_and_errors_match_jax():
    v = _vol()[..., None]  # (D, H, W, 1) through an ImageFeature
    got = t3d.AffineTransform3D(np.eye(3))(tis.ImageFeature(image=v))
    want = j3d.AffineTransform3D(np.eye(3))(jis.ImageFeature(image=v))
    assert got["image"].shape == v.shape
    np.testing.assert_array_equal(got["image"], want["image"])
    chain = t3d.CenterCrop3D(4, 4, 4) | t3d.Rotate3D((0.4, 0, 0))
    jchain = j3d.CenterCrop3D(4, 4, 4) | j3d.Rotate3D((0.4, 0, 0))
    np.testing.assert_array_equal(
        chain(tis.ImageFeature(image=v))["image"],
        jchain(jis.ImageFeature(image=v))["image"])
    w = _vol(5, 5, 5)
    np.testing.assert_array_equal(t3d.warp_3d(w, _grid()),
                                  j3d.warp_3d(w, _grid()))
    np.testing.assert_allclose(t3d.warp_3d(w, _grid()), w, atol=1e-6)
    with pytest.raises(ValueError):
        t3d.Crop3D((6, 0, 0), (4, 4, 4)).transform_volume(_vol())
    with pytest.raises(ValueError):
        t3d.AffineTransform3D(np.eye(3), pad_val=3.0)
    assert tdata.Rotate3D is t3d.Rotate3D
