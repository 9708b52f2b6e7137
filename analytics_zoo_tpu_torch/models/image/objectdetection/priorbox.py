"""SSD prior (anchor/default) box generation (a copy of the JAX package's
numpy module ``analytics_zoo_tpu.models.image.objectdetection.priorbox``).

Ref: the PriorBox layers inside models/image/objectdetection/ssd/SSDGraph,
where a BigDL layer recomputes priors on every forward. Priors depend only
on the static config, so they are computed once in numpy when the model is
built, a constant (P, 4) array.

Conventions follow the Caffe-SSD PriorBox layer the reference mirrors:
per cell one box of scale ``min_size``, one of scale ``sqrt(min*max)``,
plus a pair per extra aspect ratio (r and 1/r when ``flip``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class PriorBoxSpec:
    """One feature map's prior configuration."""

    feature_size: int              # spatial size f (map is f x f)
    step: float                    # input pixels per cell
    min_size: float                # box scale in input pixels
    max_size: Optional[float]      # sqrt(min*max) box; None to skip
    aspect_ratios: Sequence[float] = (2.0,)   # extra ratios (1.0 implicit)
    flip: bool = True              # also emit 1/r for each ratio
    offset: float = 0.5            # cell-center offset
    variances: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    clip: bool = False

    def boxes_per_cell(self) -> int:
        """Number of anchors per feature-map cell this spec generates."""
        n = 1 + (1 if self.max_size else 0)
        n += len(self.aspect_ratios) * (2 if self.flip else 1)
        return n


def _cell_sizes(spec: PriorBoxSpec, img_size: float) -> List[Tuple[float, float]]:
    """(w, h) of each prior in normalised units, Caffe-SSD emission order."""
    s = spec.min_size / img_size
    out = [(s, s)]
    if spec.max_size:
        sp = float(np.sqrt(spec.min_size * spec.max_size)) / img_size
        out.append((sp, sp))
    for r in spec.aspect_ratios:
        sr = float(np.sqrt(r))
        out.append((s * sr, s / sr))
        if spec.flip:
            out.append((s / sr, s * sr))
    return out


def generate_priors(specs: Sequence[PriorBoxSpec], img_size: int) -> np.ndarray:
    """All priors for a model, concatenated map-major: (P, 4) corner boxes.

    Order matches the head-output flattening in ``ssd.py``: feature maps in
    the given order; within a map row-major cells; within a cell the
    ``_cell_sizes`` order — so ``loc[:, i]`` aligns with ``priors[i]``.
    """
    all_boxes = []
    for spec in specs:
        f = spec.feature_size
        sizes = np.asarray(_cell_sizes(spec, float(img_size)))     # (k, 2)
        ij = np.arange(f, dtype=np.float64)
        cx = (ij + spec.offset) * spec.step / img_size             # (f,)
        cy = cx
        # centers (f, f, 2) row-major: y outer, x inner (cell (row i, col j))
        centers = np.stack(np.meshgrid(cx, cy, indexing="xy"), axis=-1)
        centers = centers.reshape(f * f, 1, 2)                     # (f*f,1,2)
        half = 0.5 * sizes[None, :, :]                             # (1,k,2)
        mins = centers - half
        maxs = centers + half
        boxes = np.concatenate([mins, maxs], axis=-1).reshape(-1, 4)
        if spec.clip:
            boxes = np.clip(boxes, 0.0, 1.0)
        all_boxes.append(boxes)
    return np.concatenate(all_boxes, axis=0).astype(np.float32)
