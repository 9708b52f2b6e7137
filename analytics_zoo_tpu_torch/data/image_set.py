"""ImageSet and its image transforms (port of
``analytics_zoo_tpu.data.image_set``; ref feature/image: ``ImageSet``,
ImageSet.scala:46,140, the OpenCV-backed ``ImageProcessing`` ops, decode
via ``OpenCVMethod.fromImageBytes``, OpenCVMethod.scala:36).

A copy of the JAX package's host module: the transforms run on the host in
numpy and OpenCV (``cv2``, imported if present, as in the JAX package) and
produce statically shaped NHWC batches; chains compose with ``|`` or
``.then``. Its one device seam is ``to_feature_set(device_normalize=True)``:
the chain stops at uint8 pixels on the host, and the trailing
``ImageChannelNormalize`` runs as a torch function on the device batch,
the feature set's ``device_transform``, which the port's ``Estimator``
applies in its train, evaluate and predict steps. ``memory_type="device"``
holds the set on the card (``DeviceCachedFeatureSet``).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class ImageFeature(dict):
    """Per-image record (ref ImageFeature): keys ``image`` (HWC uint8/float
    ndarray), ``label``, ``uri``."""

    @property
    def image(self):
        """The current image array (decoded/transformed)."""
        return self["image"]

    @property
    def label(self):
        """The feature's label (or None)."""
        return self.get("label")


# ---------------------------------------------------------------------------
# Transformers (ref feature/image/*.scala — one class per op)
# ---------------------------------------------------------------------------


def _feature_rng(f: "ImageFeature", default) -> np.random.Generator:
    """The RNG a random transform must draw from for this sample.

    A per-sample generator injected by the streaming pipeline
    (``f["rng"]``, seeded from (pipeline seed, epoch, sample index))
    wins over the transform's own sequential stream — augmentations are
    then a pure function of the sample's identity, bitwise identical for
    any map-worker count. Outside a pipeline the transform's own
    ``seed``-constructed stream keeps the legacy sequential behavior.
    """
    r = f.get("rng")
    return r if r is not None else default


class ImageProcessing:
    """Composable per-image transform (ref ImageProcessing.scala). Chain with
    ``a | b`` mirroring the reference's ``->``."""

    def apply(self, feature: ImageFeature) -> ImageFeature:
        """Transform one ImageFeature in place and return it."""
        raise NotImplementedError

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        return self.apply(feature)

    def __or__(self, other: "ImageProcessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    then = __or__


class ChainedPreprocessing(ImageProcessing):
    def __init__(self, stages: Sequence[ImageProcessing]):
        self.stages = list(stages)

    def apply(self, feature: ImageFeature) -> ImageFeature:
        for s in self.stages:
            feature = s(feature)
        return feature

    def __or__(self, other: ImageProcessing) -> "ChainedPreprocessing":
        return ChainedPreprocessing(self.stages + [other])


class ImageBytesToMat(ImageProcessing):
    """Decode encoded bytes (ref OpenCVMethod.fromImageBytes:36)."""

    def apply(self, f: ImageFeature) -> ImageFeature:
        buf = np.frombuffer(f["bytes"], np.uint8)
        f["image"] = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        return f


class ImageRead(ImageProcessing):
    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = cv2.imread(f["uri"], cv2.IMREAD_COLOR)
        if f["image"] is None:
            raise IOError(f"cannot read image {f['uri']}")
        return f


class ImageResize(ImageProcessing):
    """Ref ImageResize.scala."""

    def __init__(self, resize_h: int, resize_w: int, interpolation: int = 1):
        self.h, self.w = resize_h, resize_w
        self.interp = interpolation

    def apply(self, f: ImageFeature) -> ImageFeature:
        # record the source size so ImageRoiResize can rescale pixel-coord
        # rois (normalized rois are resize-invariant)
        f["size_before_resize"] = f["image"].shape[:2]
        f["image"] = cv2.resize(f["image"], (self.w, self.h),
                                interpolation=self.interp)
        return f


class ImageAspectScale(ImageProcessing):
    """Ref AspectScale — scale the short side to ``min_size`` capped by
    ``max_size``, preserving aspect."""

    def __init__(self, min_size: int, max_size: int = 1000, scale_multiple: int = 1):
        self.min_size, self.max_size = min_size, max_size
        self.mult = scale_multiple

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"]
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = min(self.min_size / short, self.max_size / long)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        if self.mult > 1:
            nh = (nh // self.mult) * self.mult
            nw = (nw // self.mult) * self.mult
        f["image"] = cv2.resize(img, (nw, nh))
        f["scale"] = scale
        return f


class ImageRandomAspectScale(ImageProcessing):
    """Pick the short-side target at random from ``min_sizes`` then
    aspect-preserving scale (ref ImageRandomAspectScale.scala — the
    multi-scale detection-training resize)."""

    def __init__(self, min_sizes: Sequence[int], max_size: int = 1000,
                 scale_multiple: int = 1, seed=None):
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.mult = scale_multiple
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        pick = int(rng.choice(self.min_sizes))
        return ImageAspectScale(pick, self.max_size, self.mult).apply(f)


def _check_crop(img, ch, cw, uri):
    h, w = img.shape[:2]
    if h < ch or w < cw:
        raise ValueError(
            f"crop ({ch}x{cw}) larger than image ({h}x{w})"
            f"{' for ' + str(uri) if uri else ''} — resize first")


class ImageCenterCrop(ImageProcessing):
    def __init__(self, crop_h: int, crop_w: int):
        self.ch, self.cw = crop_h, crop_w

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"]
        _check_crop(img, self.ch, self.cw, f.get("uri"))
        h, w = img.shape[:2]
        y = (h - self.ch) // 2
        x = (w - self.cw) // 2
        f["image"] = img[y:y + self.ch, x:x + self.cw]
        return f


class ImageRandomCrop(ImageProcessing):
    def __init__(self, crop_h: int, crop_w: int, seed: Optional[int] = None):
        self.ch, self.cw = crop_h, crop_w
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        img = f["image"]
        _check_crop(img, self.ch, self.cw, f.get("uri"))
        h, w = img.shape[:2]
        y = int(rng.integers(0, h - self.ch + 1))
        x = int(rng.integers(0, w - self.cw + 1))
        f["image"] = img[y:y + self.ch, x:x + self.cw]
        return f


class ImageHFlip(ImageProcessing):
    """Ref ImageHFlip — unconditional horizontal flip."""

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = f["image"][:, ::-1]
        return f


class ImageRandomFlip(ImageProcessing):
    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        if rng.random() < self.p:
            f["image"] = f["image"][:, ::-1]
        return f


class ImageBrightness(ImageProcessing):
    """Ref Brightness — add delta in [delta_low, delta_high]."""

    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        delta = rng.uniform(self.lo, self.hi)
        f["image"] = np.clip(f["image"].astype(np.float32) + delta, 0, 255)
        return f


class ImageContrast(ImageProcessing):
    def __init__(self, delta_low: float, delta_high: float, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        c = rng.uniform(self.lo, self.hi)
        img = f["image"].astype(np.float32)
        f["image"] = np.clip((img - img.mean()) * c + img.mean(), 0, 255)
        return f


class ImageHue(ImageProcessing):
    def __init__(self, delta_low: float = -18, delta_high: float = 18, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        hsv = cv2.cvtColor(f["image"].astype(np.uint8), cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(self.lo, self.hi)) % 180
        f["image"] = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
        return f


class ImageSaturation(ImageProcessing):
    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5, seed=None):
        self.lo, self.hi = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        hsv = cv2.cvtColor(f["image"].astype(np.uint8), cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(self.lo, self.hi), 0, 255)
        f["image"] = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
        return f


class ImageChannelNormalize(ImageProcessing):
    """Ref ChannelNormalize — per-channel (x - mean) / std."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0):
        # stored BGR to match OpenCV decode order (as the reference does)
        self.mean = np.array([mean_b, mean_g, mean_r], np.float32)
        self.std = np.array([std_b, std_g, std_r], np.float32)

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = (f["image"].astype(np.float32) - self.mean) / self.std
        return f


class ImagePixelNormalize(ImageProcessing):
    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = f["image"].astype(np.float32) - self.means.reshape(f["image"].shape)
        return f


class ImageChannelOrder(ImageProcessing):
    """BGR <-> RGB (ref ChannelOrder)."""

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = f["image"][..., ::-1]
        return f


class ImageExpand(ImageProcessing):
    """Ref Expand — place image on a larger mean-filled canvas."""

    def __init__(self, means=(123, 117, 104), max_ratio: float = 4.0, seed=None):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_ratio
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        img = f["image"]
        h, w, c = img.shape
        ratio = rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.ones((nh, nw, c), np.float32) * self.means
        y = int(rng.integers(0, nh - h + 1))
        x = int(rng.integers(0, nw - w + 1))
        canvas[y:y + h, x:x + w] = img
        f["image"] = canvas
        roi = f.get("roi")
        if roi is not None and f.get("roi_normalized", False):
            # map normalized boxes onto the expanded canvas (the reference
            # chains ImageExpand -> ImageRoiProject for this)
            r = np.asarray(roi, np.float32).reshape(-1, 5).copy()
            r[:, 1:] = (r[:, 1:] * np.array([w, h, w, h], np.float32)
                        + np.array([x, y, x, y], np.float32)) / \
                np.array([nw, nh, nw, nh], np.float32)
            f["roi"] = r
        return f


class ImageFiller(ImageProcessing):
    """Ref Filler — fill a normalized-coordinate region with a value."""

    def __init__(self, start_x: float, start_y: float, end_x: float, end_y: float,
                 value: int = 255):
        self.box = (start_x, start_y, end_x, end_y)
        self.value = value

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"]
        h, w = img.shape[:2]
        x0, y0, x1, y1 = self.box
        img[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)] = self.value
        f["image"] = img
        return f


class ImageSetToSample(ImageProcessing):
    """Ref ImageSetToSample — finalize (image, label) for batching; converts
    HWC BGR float to the configured layout."""

    def __init__(self, to_rgb: bool = True, to_chw: bool = False,
                 dtype=np.float32):
        self.to_rgb = to_rgb
        self.to_chw = to_chw
        self.dtype = dtype

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"].astype(self.dtype)
        if self.to_rgb:
            img = img[..., ::-1]
        if self.to_chw:
            img = np.transpose(img, (2, 0, 1))
        f["sample"] = np.ascontiguousarray(img)
        return f


# MatToTensor alias for reference-name parity
ImageMatToTensor = ImageSetToSample


class ImageRandomPreprocessing(ImageProcessing):
    """Apply a (possibly chained) transform with probability ``prob``
    (ref ImageRandomPreprocessing.scala)."""

    def __init__(self, preprocessing: ImageProcessing, prob: float,
                 seed: Optional[int] = None):
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob should be in [0.0, 1.0], got {prob}")
        self.preprocessing = preprocessing
        self.prob = float(prob)
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        if rng.random() < self.prob:
            return self.preprocessing(f)
        return f


class ImageColorJitter(ImageProcessing):
    """Photometric distortion bundle (ref ImageColorJitter.scala →
    BigDL ColorJitter): brightness/contrast/hue/saturation each applied
    with a probability, plus optional random channel reorder."""

    def __init__(self, brightness_prob: float = 0.5,
                 brightness_delta: float = 32,
                 contrast_prob: float = 0.5, contrast_lower: float = 0.5,
                 contrast_upper: float = 1.5,
                 hue_prob: float = 0.5, hue_delta: float = 18,
                 saturation_prob: float = 0.5, saturation_lower: float = 0.5,
                 saturation_upper: float = 1.5,
                 random_channel_order_prob: float = 0.0,
                 shuffle: bool = False, seed: Optional[int] = None):
        # independent child streams — reusing the seed verbatim would make
        # the gate and the four distortion magnitudes perfectly correlated
        seeds = (np.random.SeedSequence(seed).spawn(5)
                 if seed is not None else [None] * 5)
        self.rng = np.random.default_rng(seeds[0])
        self.shuffle = shuffle
        self.channel_order_prob = random_channel_order_prob
        self.ops = [
            (brightness_prob,
             ImageBrightness(-brightness_delta, brightness_delta,
                             seed=seeds[1])),
            (contrast_prob,
             ImageContrast(contrast_lower, contrast_upper, seed=seeds[2])),
            (hue_prob, ImageHue(-hue_delta, hue_delta, seed=seeds[3])),
            (saturation_prob,
             ImageSaturation(saturation_lower, saturation_upper,
                             seed=seeds[4])),
        ]

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        ops = list(self.ops)
        if self.shuffle:
            rng.shuffle(ops)
        for prob, op in ops:
            if rng.random() < prob:
                f = op(f)
        if rng.random() < self.channel_order_prob:
            perm = rng.permutation(3)
            f["image"] = np.ascontiguousarray(f["image"][..., perm])
        return f


class ImageChannelScaledNormalizer(ImageProcessing):
    """(x - per-channel mean) * scale (ref ImageChannelScaledNormalizer.scala;
    means given RGB-order as in the reference API, applied to BGR data)."""

    def __init__(self, mean_r: float, mean_g: float, mean_b: float,
                 scale: float):
        self.mean = np.array([mean_b, mean_g, mean_r], np.float32)
        self.scale = float(scale)

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = (f["image"].astype(np.float32) - self.mean) * self.scale
        return f


class ImageFixedCrop(ImageProcessing):
    """Crop a fixed region, given normalized or pixel coords
    (ref ImageFixedCrop.scala)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool, is_clip: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized
        self.is_clip = is_clip

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"]
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, y1, x2, y2 = x1 * w, y1 * h, x2 * w, y2 * h
        if self.is_clip:
            x1, x2 = max(0, x1), min(w, x2)
            y1, y2 = max(0, y1), min(h, y2)
        x1, y1, x2, y2 = int(round(x1)), int(round(y1)), \
            int(round(x2)), int(round(y2))
        if x2 <= x1 or y2 <= y1:
            raise ValueError(f"empty crop {self.box} on {h}x{w} image")
        f["image"] = img[y1:y2, x1:x2]
        return f


class ImageRandomCropper(ImageProcessing):
    """Random or center crop to a fixed size with optional random mirror
    (ref ImageRandomCropper.scala → BigDL RandomCropper)."""

    def __init__(self, crop_width: int, crop_height: int, mirror: bool = False,
                 cropper_method: str = "random", channels: int = 3,
                 seed: Optional[int] = None):
        if cropper_method not in ("random", "center"):
            raise ValueError("cropper_method must be 'random' or 'center'")
        self.cw, self.ch = crop_width, crop_height
        self.mirror = mirror
        self.method = cropper_method
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        img = f["image"]
        _check_crop(img, self.ch, self.cw, f.get("uri"))
        h, w = img.shape[:2]
        if self.method == "random":
            y = int(rng.integers(0, h - self.ch + 1))
            x = int(rng.integers(0, w - self.cw + 1))
        else:
            y, x = (h - self.ch) // 2, (w - self.cw) // 2
        img = img[y:y + self.ch, x:x + self.cw]
        if self.mirror and rng.random() < 0.5:
            img = img[:, ::-1]
        f["image"] = img
        return f


class ImageRandomResize(ImageProcessing):
    """Resize the short side to a random size in [min_size, max_size],
    preserving aspect (ref ImageRandomResize.scala)."""

    def __init__(self, min_size: int, max_size: int,
                 seed: Optional[int] = None):
        self.min_size, self.max_size = min_size, max_size
        self.rng = np.random.default_rng(seed)

    def apply(self, f: ImageFeature) -> ImageFeature:
        rng = _feature_rng(f, self.rng)
        img = f["image"]
        h, w = img.shape[:2]
        target = int(rng.integers(self.min_size, self.max_size + 1))
        scale = target / min(h, w)
        f["size_before_resize"] = (h, w)
        f["image"] = cv2.resize(img, (int(round(w * scale)),
                                      int(round(h * scale))))
        return f


class BufferedImageResize(ImageProcessing):
    """Resize *encoded* bytes before decode (ref BufferedImageResize.scala —
    there a JVM ImageIO path; here decode→resize→re-encode with OpenCV),
    keeping ``f["bytes"]`` encoded for a downstream ImageBytesToMat."""

    def __init__(self, resize_h: int, resize_w: int, ext: str = ".png"):
        self.h, self.w = resize_h, resize_w
        self.ext = ext

    def apply(self, f: ImageFeature) -> ImageFeature:
        buf = np.frombuffer(f["bytes"], np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if img.shape[0] != self.h or img.shape[1] != self.w:
            img = cv2.resize(img, (self.w, self.h))
        ok, enc = cv2.imencode(self.ext, img)
        if not ok:
            raise IOError(f"re-encode failed ({self.ext})")
        f["bytes"] = enc.tobytes()
        return f


class ImagePixelBytesToMat(ImageProcessing):
    """Raw pixel bytes (H*W*C uint8, BGR) → image, using the stored
    ``height``/``width``/``channels`` keys (ref ImagePixelBytesToMat.scala)."""

    def __init__(self, byte_key: str = "bytes"):
        self.byte_key = byte_key

    def apply(self, f: ImageFeature) -> ImageFeature:
        h, w = int(f["height"]), int(f["width"])
        c = int(f.get("channels", 3))
        buf = np.frombuffer(f[self.byte_key], np.uint8)
        f["image"] = buf.reshape(h, w, c).copy()
        return f


class ImageMatToFloats(ImageProcessing):
    """Float conversion with a fixed valid output size: pads (bottom/right,
    zeros) or center-crops so every image leaves the chain at exactly
    (valid_height, valid_width) — the static-shape contract the batcher
    relies on (ref ImageMatToFloats.scala)."""

    def __init__(self, valid_height: int, valid_width: int):
        self.h, self.w = valid_height, valid_width

    def apply(self, f: ImageFeature) -> ImageFeature:
        img = f["image"].astype(np.float32)
        h, w = img.shape[:2]
        if h != self.h or w != self.w:
            out = np.zeros((self.h, self.w, img.shape[2]), np.float32)
            ch, cw = min(h, self.h), min(w, self.w)
            out[:ch, :cw] = img[:ch, :cw]
            img = out
        f["image"] = img
        return f


# ---------------------------------------------------------------------------
# ImageSet
# ---------------------------------------------------------------------------


class ImageSet:
    """Collection of ImageFeatures + lazy transform chain (ref ImageSet.scala).

    ``read`` mirrors ``ImageSet.read(path)``:236 — local folder (class
    subdirs become labels when ``with_label``) or file list.
    """

    def __init__(self, features: List[ImageFeature],
                 label_map: Optional[dict] = None):
        self.features = features
        self.label_map = label_map or {}
        self._chain: List[ImageProcessing] = []

    @staticmethod
    def read(path: Union[str, Sequence[str]], with_label: bool = False,
             one_based_label: bool = False) -> "ImageSet":
        """Read images from a path/glob into an ImageSet (cv2 decode;
        ref ImageSet.read).
        """
        feats: List[ImageFeature] = []
        label_map = {}
        if isinstance(path, str) and os.path.isdir(path):
            if with_label:
                classes = sorted(d for d in os.listdir(path)
                                 if os.path.isdir(os.path.join(path, d)))
                base = 1 if one_based_label else 0
                label_map = {c: i + base for i, c in enumerate(classes)}
                for c in classes:
                    for fn in sorted(os.listdir(os.path.join(path, c))):
                        feats.append(ImageFeature(
                            uri=os.path.join(path, c, fn), label=label_map[c]))
            else:
                for fn in sorted(os.listdir(path)):
                    full = os.path.join(path, fn)
                    if os.path.isfile(full):
                        feats.append(ImageFeature(uri=full))
        else:
            paths = [path] if isinstance(path, str) else list(path)
            feats = [ImageFeature(uri=p) for p in paths]
        s = ImageSet(feats, label_map)
        s._chain = [ImageRead()]
        return s

    @staticmethod
    def from_arrays(images: np.ndarray, labels: Optional[np.ndarray] = None) -> "ImageSet":
        """Build an ImageSet from in-memory ndarrays (+ optional labels)."""
        feats = []
        for i in range(len(images)):
            f = ImageFeature(image=np.asarray(images[i]))
            if labels is not None:
                f["label"] = labels[i]
            feats.append(f)
        return ImageSet(feats)

    def transform(self, processing: ImageProcessing) -> "ImageSet":
        """Apply an ImageProcessing (or chain) to every feature."""
        self._chain.append(processing)
        return self

    def get_image(self) -> List[np.ndarray]:
        """All decoded (transformed) image arrays, one (H, W, C) per
        feature (ref ImageSet.toImageFrame image access)."""
        return [self._apply(f)["image"] for f in self.features]

    def _apply(self, f: ImageFeature, chain=None) -> ImageFeature:
        out = ImageFeature(f)
        if "image" in out:
            # deep-copy the pixel data: transforms like ImageFiller write in
            # place, and crops create views — without this they would mutate
            # the caller's source arrays across materializations
            out["image"] = np.array(out["image"], copy=True)
        for t in (self._chain if chain is None else chain):
            out = t(out)
        return out

    def to_feature_set(self, device_normalize: bool = False,
                       memory_type: str = "dram"):
        """Materialize into a FeatureSet for the training engine.

        ``memory_type`` picks the cache level, mirroring the reference's
        FeatureSet memory-type choice (feature/FeatureSet.scala:216 DRAM,
        feature/pmem/ PMEM) plus the device level above both:
        ``"dram"`` — host ndarrays (default); ``"device"`` — resident in
        device memory with on-device per-batch gather
        (DeviceCachedFeatureSet; pair with ``device_normalize=True`` so the
        cache stays uint8).

        ``device_normalize=True`` splits the pipeline at the trailing
        ImageChannelNormalize: host transforms stop at uint8 pixels (4x
        fewer bytes over the host-to-device link) and the normalize runs on
        the device batch, in the train/evaluate/predict steps, through the
        feature set's ``device_transform``. Pixels are round-quantized to
        uint8 at the boundary (at most 0.5 of a pixel level, i.e.
        0.5 / std after the normalize, against the host-side float path).
        Requires the chain to end ImageChannelNormalize [-> ImageSetToSample];
        raises otherwise so silent semantic drift is impossible.
        """
        from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet

        chain = self._chain
        device_transform = None
        if device_normalize:
            chain, device_transform = self._split_device_normalize()
        samples, labels = [], []
        for f in self.features:
            out = self._apply(f, chain=chain)
            samples.append(out.get("sample", out["image"]))
            if "label" in out:
                labels.append(out["label"])
        x = np.stack(samples)
        y = np.asarray(labels) if labels else None
        fs = ArrayFeatureSet(x, y)
        fs.device_transform = device_transform
        if memory_type == "device":
            fs = fs.cache_device()
        elif memory_type != "dram":
            raise ValueError(f"memory_type must be dram|device, got {memory_type}")
        return fs

    def _split_device_normalize(self):
        """Rewrite the chain for uint8 infeed: drop the trailing
        ImageChannelNormalize and return (host_chain, device_fn) where
        ``device_fn`` applies the same normalize on a batched device array,
        accounting for any ImageSetToSample channel reorder/layout after it."""
        # flatten `a | b | c` chains so the normalize is found no matter how
        # the user composed the pipeline (transform() calls vs the | algebra)
        flat: List[ImageProcessing] = []

        def _flatten(t):
            if isinstance(t, ChainedPreprocessing):
                for s in t.stages:
                    _flatten(s)
            else:
                flat.append(t)

        for t in self._chain:
            _flatten(t)
        norm_like = [
            i for i, t in enumerate(flat)
            if isinstance(t, (ImageChannelNormalize, ImagePixelNormalize,
                              ImageChannelScaledNormalizer))
        ]
        if not norm_like:
            raise ValueError(
                "device_normalize=True needs an ImageChannelNormalize in the "
                "transform chain")
        if (len(norm_like) != 1
                or not isinstance(flat[norm_like[0]], ImageChannelNormalize)):
            # an earlier normalize would leave non-[0,255] pixels that the
            # uint8 quantization at the split boundary would destroy
            raise ValueError(
                "device_normalize=True requires exactly one normalization op "
                "(an ImageChannelNormalize) in the chain; found "
                f"{[type(flat[i]).__name__ for i in norm_like]}")
        norm_idx = norm_like[0]
        tail = flat[norm_idx + 1:]
        if not all(isinstance(t, ImageSetToSample) for t in tail):
            raise ValueError(
                "device_normalize=True requires ImageChannelNormalize to be "
                f"followed only by ImageSetToSample, got {tail}")
        norm = flat[norm_idx]
        mean, std = norm.mean.copy(), norm.std.copy()  # BGR order, HWC layout
        to_chw = False
        for t in tail:
            if t.to_rgb:
                mean, std = mean[::-1].copy(), std[::-1].copy()
            to_chw = to_chw or t.to_chw
        host_chain = (flat[:norm_idx]
                      + [_ImageQuantizeU8()]
                      + [ImageSetToSample(to_rgb=t.to_rgb, to_chw=t.to_chw,
                                          dtype=np.uint8) for t in tail])
        if not tail:
            host_chain.append(ImageSetToSample(to_rgb=False, to_chw=False,
                                               dtype=np.uint8))

        bshape = (1, -1, 1, 1) if to_chw else (1, 1, 1, -1)
        # mean and std on each device, copied there once: a copy per call
        # from host memory would make every step wait for the one before
        consts = {}

        def device_fn(x):
            import torch

            if x.device not in consts:
                consts[x.device] = tuple(
                    torch.tensor(v, device=x.device).reshape(bshape)
                    for v in (mean, std))
            m, s = consts[x.device]
            return (x.float() - m) / s

        return host_chain, device_fn


class _ImageQuantizeU8(ImageProcessing):
    """Round-clip pixels to uint8 at the host/device boundary (internal to
    ``to_feature_set(device_normalize=True)``)."""

    def apply(self, f: ImageFeature) -> ImageFeature:
        f["image"] = np.clip(np.rint(f["image"]), 0, 255).astype(np.uint8)
        return f
