"""``ImageSet`` and its transforms in the port against the JAX package, on
the CPU.

The port's ``data/image_set.py`` is a copy of the JAX package's host
module, so every transform must give the same result bit for bit: each
one runs in both packages on the same seeded uint8 images (the random ones
with the same seed), and every key of the resulting feature is compared
exactly, dtype included. ``ImageSet.read``, ``from_arrays``,
``transform``, ``get_image`` and ``to_feature_set`` are compared the same
way. ``to_feature_set(device_normalize=True)`` stops the host chain at
uint8 pixels and normalizes on the device (a torch function here, jnp in
the JAX package): its output is held against the host-normalized float
path within the quantization bound 0.5 / std (each pixel rounds to the
nearest integer level before the normalize; plus 1e-5 for the f32
arithmetic), and against the JAX package's device function bitwise.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import image_set as jis
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import image_set as tis


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()


def _image(seed, h=24, w=30):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3)).astype(np.uint8)


def _png(img):
    ok, enc = cv2.imencode(".png", img)
    assert ok
    return enc.tobytes()


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


# (name, args, kwargs, extra feature keys)
TRANSFORMS = [
    ("ImageResize", (16, 20), {}, {}),
    ("ImageAspectScale", (20,), dict(max_size=40, scale_multiple=4), {}),
    ("ImageRandomAspectScale", ((12, 16, 20),), dict(seed=1), {}),
    ("ImageCenterCrop", (16, 20), {}, {}),
    ("ImageRandomCrop", (16, 20), dict(seed=2), {}),
    ("ImageHFlip", (), {}, {}),
    ("ImageRandomFlip", (), dict(p=0.5, seed=3), {}),
    ("ImageBrightness", (-32, 32), dict(seed=4), {}),
    ("ImageContrast", (0.5, 1.5), dict(seed=5), {}),
    ("ImageHue", (), dict(seed=6), {}),
    ("ImageSaturation", (), dict(seed=7), {}),
    ("ImageChannelNormalize", (123.0, 117.0, 104.0, 58.4, 57.1, 57.4), {},
     {}),
    ("ImagePixelNormalize", (np.full((24, 30, 3), 100.0),), {}, {}),
    ("ImageChannelOrder", (), {}, {}),
    ("ImageExpand", (), dict(max_ratio=2.0, seed=8),
     {"roi": np.array([[1, 0.1, 0.2, 0.5, 0.6]], np.float32),
      "roi_normalized": True}),
    ("ImageFiller", (0.1, 0.2, 0.5, 0.7), dict(value=7), {}),
    ("ImageSetToSample", (), dict(to_rgb=True, to_chw=True), {}),
    ("ImageMatToTensor", (), {}, {}),
    ("ImageColorJitter", (), dict(random_channel_order_prob=0.5,
                                  shuffle=True, seed=9), {}),
    ("ImageChannelScaledNormalizer", (123.0, 117.0, 104.0, 0.017), {}, {}),
    ("ImageFixedCrop", (0.1, 0.1, 0.8, 0.9, True), {}, {}),
    ("ImageFixedCrop", (2, 3, 20, 18, False), dict(is_clip=False), {}),
    ("ImageRandomCropper", (20, 16), dict(mirror=True, seed=10), {}),
    ("ImageRandomCropper", (20, 16), dict(cropper_method="center"), {}),
    ("ImageRandomResize", (12, 20), dict(seed=11), {}),
    ("ImageMatToFloats", (20, 40), {}, {}),
]


@pytest.mark.parametrize("name,args,kw,extra", TRANSFORMS,
                         ids=[f"{t[0]}-{i}" for i, t in enumerate(TRANSFORMS)])
def test_transform_matches_jax_bitwise(name, args, kw, extra):
    tj = getattr(jis, name)(*args, **kw)
    tt = getattr(tis, name)(*args, **kw)
    for seed in range(4):  # a random transform draws anew for each image
        img = _image(seed)
        got = tt(tis.ImageFeature(image=img.copy(), **extra))
        want = tj(jis.ImageFeature(image=img.copy(), **extra))
        _assert_same(got, want)


def test_byte_transforms_and_random_preprocessing_match_jax():
    img = _image(20)
    cases = [
        ("ImageBytesToMat", (), {"bytes": _png(img)}),
        ("BufferedImageResize", (12, 16), {"bytes": _png(img)}),
        ("ImagePixelBytesToMat", (), {"bytes": img.tobytes(), "height": 24,
                                       "width": 30, "channels": 3}),
    ]
    for name, args, feat in cases:
        _assert_same(getattr(tis, name)(*args)(tis.ImageFeature(feat)),
                     getattr(jis, name)(*args)(jis.ImageFeature(feat)))
    for prob in (0.0, 0.5, 1.0):
        tt = tis.ImageRandomPreprocessing(
            tis.ImageHFlip() | tis.ImageBrightness(-8, 8, seed=1), prob,
            seed=2)
        tj = jis.ImageRandomPreprocessing(
            jis.ImageHFlip() | jis.ImageBrightness(-8, 8, seed=1), prob,
            seed=2)
        for seed in range(4):
            _assert_same(tt(tis.ImageFeature(image=_image(seed))),
                         tj(jis.ImageFeature(image=_image(seed))))
    with pytest.raises(ValueError, match="prob"):
        tis.ImageRandomPreprocessing(tis.ImageHFlip(), 1.5)
    with pytest.raises(ValueError, match="resize first"):
        tis.ImageCenterCrop(40, 40)(tis.ImageFeature(image=_image(0)))


def _chain(mod):
    return (mod.ImageResize(20, 20) | mod.ImageRandomCrop(16, 16, seed=3)
            | mod.ImageChannelNormalize(123.0, 117.0, 104.0, 58.4, 57.1, 57.4)
            | mod.ImageSetToSample(to_rgb=True))


def test_image_set_read_and_chains_match_jax(tmp_path):
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            cv2.imwrite(str(tmp_path / cls / f"{i}.png"),
                        _image(10 * len(cls) + i))
    sets = []
    for mod in (tis, jis):
        s = mod.ImageSet.read(str(tmp_path), with_label=True,
                              one_based_label=True)
        s.transform(_chain(mod))
        sets.append(s)
    ts, js = sets
    assert ts.label_map == js.label_map == {"cat": 1, "dog": 2}
    for a, b in zip(ts.get_image(), js.get_image(), strict=True):
        np.testing.assert_array_equal(a, b)
    tf_set = ts.to_feature_set()
    jf_set = js.to_feature_set()
    assert isinstance(tf_set, tfs.ArrayFeatureSet)
    np.testing.assert_array_equal(tf_set.xs[0], jf_set.xs[0])
    np.testing.assert_array_equal(tf_set.ys[0], jf_set.ys[0])
    with pytest.raises(ValueError, match="memory_type"):
        ts.to_feature_set(memory_type="pmem")
    unlabeled = tis.ImageSet.read(str(tmp_path / "cat"))
    assert len(unlabeled.get_image()) == 3


def test_from_arrays_device_normalize_matches_host_and_jax():
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 20, 20, 3)).astype(np.uint8)
    labels = rng.integers(0, 4, 6)
    norm = (123.0, 117.0, 104.0, 58.4, 57.1, 57.4)

    def build(mod, to_chw):
        s = mod.ImageSet.from_arrays(images, labels)
        s.transform(mod.ImageResize(18, 18) | mod.ImageChannelNormalize(*norm))
        return s.transform(mod.ImageSetToSample(to_rgb=True, to_chw=to_chw))

    for to_chw in (False, True):
        host = build(tis, to_chw).to_feature_set()
        dev = build(tis, to_chw).to_feature_set(device_normalize=True,
                                                memory_type="device")
        jdev = build(jis, to_chw).to_feature_set(device_normalize=True)
        assert isinstance(dev, tfs.DeviceCachedFeatureSet)
        assert dev.xs[0].dtype == np.uint8
        np.testing.assert_array_equal(dev.xs[0], jdev.xs[0])
        np.testing.assert_array_equal(dev.ys[0], host.ys[0])
        x, _ = dev.gather(torch.arange(6))
        got = dev.device_transform(x).numpy()
        want = np.asarray(jdev.device_transform(jnp.asarray(jdev.xs[0])))
        np.testing.assert_array_equal(got, want)
        bound = 0.5 / min(norm[3:]) + 1e-5
        assert np.abs(got - host.xs[0]).max() <= bound
    bad = tis.ImageSet.from_arrays(images).transform(tis.ImageHFlip())
    with pytest.raises(ValueError, match="ImageChannelNormalize"):
        bad.to_feature_set(device_normalize=True)


def test_device_normalize_copies_its_constants_once(monkeypatch):
    """The device normalize copies mean and std to a device on its first
    call only: a copy per step from host memory would make every step wait
    for the one before it."""
    images = np.random.default_rng(6).integers(0, 256, (4, 8, 8, 3))
    dev = tis.ImageSet.from_arrays(images.astype(np.uint8)).transform(
        tis.ImageChannelNormalize(123.0, 117.0, 104.0, 58.4, 57.1, 57.4)
    ).to_feature_set(device_normalize=True, memory_type="device")
    x, _ = dev.gather(torch.arange(4))
    first = dev.device_transform(x)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **kw: made.append(a) or real(*a, **kw))
    for _ in range(3):
        torch.testing.assert_close(dev.device_transform(x), first,
                                   rtol=0, atol=0)
    assert made == []
