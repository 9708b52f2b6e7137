"""TFDataset (port of ``analytics_zoo_tpu.tfpark.tf_dataset``; ref
pyzoo/zoo/pipeline/api/net/tf_dataset.py:109).

In the reference this class shards an RDD/ndarray/ImageSet/TextSet source
across Spark executors and makes TF placeholders whose batch dim obeys
``batch_size % total_cores == 0`` (tf_dataset.py:134-139). Here, as in the
JAX package, it is a named wrapper over a FeatureSet carrying that batch
geometry (the device count is the context's ``num_devices``, 1 in the
port), with the same constructor family (from_ndarrays:426, from_rdd:295,
from_image_set:548, from_text_set, from_feature_set).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
)


class TFDataset:
    """TFPark dataset wrapper: a FeatureSet plus the reference's batch
    geometry contract — ``batch_size`` must divide by the device count
    (training) or ``batch_per_thread`` scales per device (inference).
    Ref TFDataset (tf_dataset.py, APIGuide/TFPark/tf-dataset)."""
    def __init__(self, feature_set: FeatureSet, batch_size: int = -1,
                 batch_per_thread: int = -1, has_label: bool = True):
        ctx = get_nncontext()
        n = ctx.num_devices
        if batch_size > 0 and batch_size % n != 0:
            raise ValueError(
                f"batch_size ({batch_size}) should be a multiple of the "
                f"device count ({n})")  # ref tf_dataset.py:134-139 wording
        if batch_size <= 0 and batch_per_thread <= 0:
            raise ValueError(
                "one of batch_size or batch_per_thread must be set "
                "(ref TFDataset requires the batch geometry)")
        self.feature_set = feature_set
        self.batch_size = batch_size if batch_size > 0 else batch_per_thread * n
        self.has_label = has_label

    # -- constructors (ref :295-629) --------------------------------------

    @staticmethod
    def from_ndarrays(tensors, batch_size: int = -1, batch_per_thread: int = -1,
                      val_tensors=None) -> "TFDataset":
        """``tensors``: a TUPLE ``(features, labels)`` for supervised data, or
        a bare ndarray / LIST of feature arrays for unlabeled data. The
        tuple-vs-list distinction disambiguates a two-input unlabeled model
        (``[x1, x2]``) from a features/labels pair (``(x, y)``)."""
        if isinstance(tensors, tuple) and len(tensors) == 2:
            x, y = tensors
        else:
            x, y = tensors, None
        return TFDataset(ArrayFeatureSet(x, y), batch_size, batch_per_thread,
                         has_label=y is not None)

    @staticmethod
    def from_feature_set(dataset: FeatureSet, batch_size: int = -1,
                         batch_per_thread: int = -1) -> "TFDataset":
        """Wrap an existing FeatureSet (ref TFDataset.from_feature_set)."""
        return TFDataset(dataset, batch_size, batch_per_thread)

    @staticmethod
    def from_image_set(image_set, batch_size: int = -1,
                       batch_per_thread: int = -1,
                       **feature_set_kw) -> "TFDataset":
        """Materialize an ImageSet into a TFDataset (ref from_image_set);
        ``feature_set_kw`` go to ``ImageSet.to_feature_set``
        (``device_normalize``, ``memory_type``)."""
        return TFDataset(image_set.to_feature_set(**feature_set_kw),
                         batch_size, batch_per_thread)

    @staticmethod
    def from_text_set(text_set, batch_size: int = -1,
                      batch_per_thread: int = -1) -> "TFDataset":
        """Materialize a processed TextSet (ref from_text_set)."""
        return TFDataset(text_set.to_feature_set(), batch_size, batch_per_thread)

    @staticmethod
    def from_rdd(rdd, batch_size: int = -1, batch_per_thread: int = -1,
                 **kw) -> "TFDataset":
        """Spark interop: collects the RDD to host arrays (Spark stays an
        upstream source only)."""
        rows = rdd.collect() if hasattr(rdd, "collect") else list(rdd)
        first = rows[0]
        if isinstance(first, (tuple, list)) and len(first) == 2:
            x = np.asarray([r[0] for r in rows])
            y = np.asarray([r[1] for r in rows])
            return TFDataset(ArrayFeatureSet(x, y), batch_size, batch_per_thread)
        return TFDataset(ArrayFeatureSet(np.asarray(rows)), batch_size,
                         batch_per_thread, has_label=False)
