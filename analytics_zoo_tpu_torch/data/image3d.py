"""3D (medical) image transforms (port of ``analytics_zoo_tpu.data.image3d``,
on the port's ``ImageProcessing``) — ref feature/image3d/*.scala.

The reference operates on single-channel (D, H, W, 1) float tensors with
scalar per-voxel loops (Cropper.scala, Rotation.scala, Affine.scala,
Warp.scala). Here the same dst→src resampling model is vectorized numpy on
the host data path — these run in data-loading workers feeding the device,
so they never enter the model's forward.

Semantics matched to the reference:
- ``Crop3D``/``RandomCrop3D``/``CenterCrop3D`` — Cropper.scala:26-140.
- ``Rotate3D(yaw, pitch, roll)`` — Rotation.scala:23-36: combined
  yaw·pitch·roll rotation about the volume center.
- ``AffineTransform3D(mat, translation, clamp_mode, pad_val)`` —
  Affine.scala:23-82: dst→src mapping ``src_pos = c - mat·(c - dst_pos) -
  translation`` over centered coordinates.
- Trilinear resampling with "clamp" (border-clamp) or "padding" (pad_val
  off-image) — Warp.scala:30-96.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.image_set import ImageFeature, ImageProcessing

__all__ = [
    "ImageProcessing3D", "Crop3D", "RandomCrop3D", "CenterCrop3D",
    "Rotate3D", "AffineTransform3D", "warp_3d",
]


def warp_3d(src: np.ndarray, sample_zyx: np.ndarray, clamp_mode: str = "clamp",
            pad_val: float = 0.0) -> np.ndarray:
    """Trilinear resample of a (D, H, W) volume at 0-based float coordinates.

    ``sample_zyx``: (3, D', H', W') absolute source coordinates per dst voxel.
    Vectorized equivalent of the reference's per-voxel WarpTransformer loop
    (Warp.scala:51-94).
    """
    if clamp_mode not in ("clamp", "padding"):
        raise ValueError(f"clamp_mode must be clamp|padding, got {clamp_mode}")
    d, h, w = src.shape
    iz, iy, ix = sample_zyx[0], sample_zyx[1], sample_zyx[2]
    off_image = ((iz < 0) | (iz > d - 1) | (iy < 0) | (iy > h - 1)
                 | (ix < 0) | (ix > w - 1))
    iz = np.clip(iz, 0, d - 1)
    iy = np.clip(iy, 0, h - 1)
    ix = np.clip(ix, 0, w - 1)
    z0 = np.floor(iz).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    x0 = np.floor(ix).astype(np.int64)
    z1 = np.minimum(z0 + 1, d - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wz, wy, wx = iz - z0, iy - y0, ix - x0
    s = src.astype(np.float64)
    out = ((1 - wy) * (1 - wx) * (1 - wz) * s[z0, y0, x0]
           + (1 - wy) * (1 - wx) * wz * s[z1, y0, x0]
           + (1 - wy) * wx * (1 - wz) * s[z0, y0, x1]
           + (1 - wy) * wx * wz * s[z1, y0, x1]
           + wy * (1 - wx) * (1 - wz) * s[z0, y1, x0]
           + wy * (1 - wx) * wz * s[z1, y1, x0]
           + wy * wx * (1 - wz) * s[z0, y1, x1]
           + wy * wx * wz * s[z1, y1, x1])
    if clamp_mode == "padding":
        out = np.where(off_image, pad_val, out)
    return out.astype(src.dtype, copy=False)


class ImageProcessing3D(ImageProcessing):
    """Base for 3D transforms (ref ImageProcessing3D.scala): operates on the
    feature's ``image`` volume, accepting (D, H, W) or single-channel
    (D, H, W, 1)."""

    def transform_volume(self, vol: np.ndarray) -> np.ndarray:
        """Transform one (D, H, W[, C]) volume ndarray."""
        raise NotImplementedError

    def apply(self, feature: ImageFeature) -> ImageFeature:
        img = np.asarray(feature["image"])
        squeeze = False
        if img.ndim == 4:
            if img.shape[-1] != 1:
                raise ValueError(
                    "3D transforms support single-channel volumes only "
                    f"(ref Affine.scala:50), got shape {img.shape}")
            img, squeeze = img[..., 0], True
        if img.ndim != 3:
            raise ValueError(f"expected (D,H,W[,1]) volume, got {img.shape}")
        out = self.transform_volume(img)
        feature["image"] = out[..., None] if squeeze else out
        return feature


class Crop3D(ImageProcessing3D):
    """Crop a patch at ``start`` (0-based z,y,x) of ``patch_size`` (d,h,w).
    Ref Cropper.scala:26-60 (1-based there)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.patch_size = tuple(int(p) for p in patch_size)
        if len(self.start) != 3 or len(self.patch_size) != 3:
            raise ValueError("start and patch_size must have length 3")
        if any(s < 0 for s in self.start) or any(p < 0 for p in self.patch_size):
            raise ValueError("start/patch_size values must be nonnegative")

    def transform_volume(self, vol: np.ndarray) -> np.ndarray:
        for i in range(3):
            if self.start[i] + self.patch_size[i] > vol.shape[i]:
                raise ValueError(
                    f"crop [{self.start[i]}, {self.start[i] + self.patch_size[i]}) "
                    f"out of bounds for axis {i} of size {vol.shape[i]}")
        z, y, x = self.start
        d, h, w = self.patch_size
        return vol[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImageProcessing3D):
    """Random-position crop (ref Cropper.scala:63-94)."""

    def __init__(self, crop_depth: int, crop_height: int, crop_width: int,
                 rng: Optional[np.random.Generator] = None):
        self.size = (int(crop_depth), int(crop_height), int(crop_width))
        self.rng = rng or np.random.default_rng()

    def transform_volume(self, vol: np.ndarray) -> np.ndarray:
        starts = []
        for dim, c in zip(vol.shape, self.size):
            if c > dim:
                raise ValueError(f"crop size {self.size} exceeds volume {vol.shape}")
            starts.append(int(self.rng.integers(0, dim - c + 1)))
        return Crop3D(starts, self.size).transform_volume(vol)


class CenterCrop3D(ImageProcessing3D):
    """Center crop (ref Cropper.scala:96-140)."""

    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.size = (int(crop_depth), int(crop_height), int(crop_width))

    def transform_volume(self, vol: np.ndarray) -> np.ndarray:
        starts = []
        for dim, c in zip(vol.shape, self.size):
            if c > dim:
                raise ValueError(f"crop size {self.size} exceeds volume {vol.shape}")
            starts.append((dim - c) // 2)
        return Crop3D(starts, self.size).transform_volume(vol)


class AffineTransform3D(ImageProcessing3D):
    """Affine resample, mapping destination→source (ref Affine.scala:23-82):

        src_pos = c − mat·(c − dst_pos) − translation

    with ``c`` the volume center. ``clamp_mode`` "clamp" border-clamps
    off-image samples; "padding" writes ``pad_val``.
    """

    def __init__(self, mat: np.ndarray, translation: Sequence[float] = (0, 0, 0),
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(mat, np.float64).reshape(3, 3)
        self.translation = np.asarray(translation, np.float64).reshape(3)
        if clamp_mode == "clamp" and pad_val != 0.0:
            raise ValueError("pad_val requires clamp_mode='padding' "
                             "(ref Affine.scala:34)")
        self.clamp_mode = clamp_mode
        self.pad_val = float(pad_val)

    def transform_volume(self, vol: np.ndarray) -> np.ndarray:
        d, h, w = vol.shape
        # 1-based voxel coordinates as in the reference, converted at the end
        z = np.arange(1, d + 1, dtype=np.float64)[:, None, None]
        y = np.arange(1, h + 1, dtype=np.float64)[None, :, None]
        x = np.arange(1, w + 1, dtype=np.float64)[None, None, :]
        cz, cy, cx = (d + 1) / 2.0, (h + 1) / 2.0, (w + 1) / 2.0
        centered = np.stack(np.broadcast_arrays(cz - z, cy - y, cx - x))
        field = np.einsum("ij,jdhw->idhw", self.mat, centered)
        # src = center - mat.(center - dst) - translation; the dst grid cancels
        # against `centered`, leaving the constant center term.
        center = np.array([cz, cy, cx])[:, None, None, None]
        sample = center - field - self.translation[:, None, None, None]
        return warp_3d(vol, sample - 1.0, self.clamp_mode, self.pad_val)


def _rotation_matrix(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Combined yaw·pitch·roll rotation (ref Rotation.scala:36-59)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    roll_m = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    pitch_m = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    yaw_m = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return yaw_m @ pitch_m @ roll_m


class Rotate3D(AffineTransform3D):
    """Rotate about the volume center by (yaw, pitch, roll) radians
    (ref Rotation.scala:23-36), expressed as the equivalent affine."""

    def __init__(self, rotation_angles: Sequence[float], clamp_mode: str = "clamp",
                 pad_val: float = 0.0):
        yaw, pitch, roll = rotation_angles
        super().__init__(_rotation_matrix(yaw, pitch, roll),
                         clamp_mode=clamp_mode, pad_val=pad_val)
