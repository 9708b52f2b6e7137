"""Model import surface (port of ``analytics_zoo_tpu.net``) — ref
pipeline/api/net/NetUtils.scala:142-212 and pyzoo ``Net.load*`` family
(net_load.py:70-160: bigdl/torch/caffe/keras/TF).

The loaders here need neither TensorFlow nor h5py to import: ONNX graphs
(:mod:`analytics_zoo_tpu_torch.onnx`), this framework's own saved models
and weights, and weight files poured into a built zoo model (a Keras
HDF5 file through :mod:`~analytics_zoo_tpu_torch.keras_import`, h5py read
at call time; a torch ``state_dict``; a ``.caffemodel``). The GraphNet
transfer-learning surface (freeze/freeze_up_to/new_graph,
NetUtils.scala:221-280) lives on
:class:`analytics_zoo_tpu_torch.keras.engine.topology.Model` itself,
re-exported here as ``GraphNet``.

Not ported yet (ROADMAP A6, TensorFlow importers: keras_convert, tfnet):
``Net.load_tf`` and the two architecture forms of ``Net.load_keras`` (a
``to_json()`` file, or a whole-model HDF5), which raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Any

from analytics_zoo_tpu_torch.keras.engine.topology import Model as GraphNet  # noqa: F401 (re-export)

_TF_IMPORTERS = "ROADMAP A6, TensorFlow importers (keras_convert, tfnet)"


class Net:
    """Static loaders (ref net_load.py:70-160)."""

    @staticmethod
    def load(path: str) -> Any:
        """Load a model saved by this framework: a ``ZooModel.save_model``
        directory (model.json + weights) — ref Net.load / ZooModel.loadModel
        (ZooModel.scala:149)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel

        if os.path.isdir(path) and os.path.exists(
                os.path.join(path, "model.json")):
            return ZooModel.load_model(path)
        raise ValueError(
            f"'{path}' is not a saved model directory (expected model.json). "
            "For foreign formats use Net.load_onnx; for bare weights use "
            "KerasNet.load_weights on a freshly built architecture.")

    @staticmethod
    def load_onnx(path: str):
        """Import an ONNX graph (ref onnx_loader.py; replaces the reference's
        caffe/torch/TF import paths — all those frameworks export ONNX)."""
        from analytics_zoo_tpu_torch.onnx import load_model

        return load_model(path)

    @staticmethod
    def load_weights(model, path: str):
        """Restore a ``save_weights`` checkpoint into a built net."""
        return model.load_weights(path)

    @staticmethod
    def load_tf(path: str, input_names=None, output_names=None):
        """Run someone else's trained TF model (ref TFNet.scala:52,
        net_load.py:120-160). Not ported: raises ``NotImplementedError``
        (``FileNotFoundError`` for a path that does not exist, as the JAX
        package checks it first)."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"load_tf: no such path '{path}'")
        raise NotImplementedError(
            f"Net.load_tf is not ported yet ({_TF_IMPORTERS}); export the "
            "model to ONNX and use Net.load_onnx")

    @staticmethod
    def load_keras(path: str, model=None, by_name: bool = True,
                   strict: bool = True):
        """Load pre-trained Keras weights (ref Net.load_keras,
        net_load.py:153-164).

        - ``load_keras(weights_path, model)`` — pour an HDF5 *weight* file
          into an already-built zoo model, by layer name with per-type
          layout converters. Returns the imported layer names.
        - ``load_keras(json_path, hdf5_path)`` and ``load_keras(hdf5_path)``
          — the architecture forms (a ``model.to_json()`` file, a
          whole-model HDF5) need the Keras architecture converter and raise
          ``NotImplementedError`` (ROADMAP A6, TensorFlow importers).

        Note: ``by_name`` defaults to ``True`` here (the reference defaults
        to ``False``). Zoo layer names are kept 1:1 with the published
        names, so name matching is the robust default; pass
        ``by_name=False`` for positional matching of a rebuilt
        architecture.
        """
        from analytics_zoo_tpu_torch.keras_import import load_keras_weights

        if model is None or isinstance(model, str):
            raise NotImplementedError(
                "Net.load_keras with an architecture (a to_json() file or a "
                f"whole-model HDF5) is not ported yet ({_TF_IMPORTERS}); "
                "build the zoo model and call load_keras(weights_path, "
                "model)")
        return load_keras_weights(model, path, by_name=by_name,
                                  strict=strict)

    @staticmethod
    def load_caffe(weights_path, model, name_map=None, strict: bool = True):
        """Pour a ``.caffemodel`` into a built zoo model (ref Net.load_caffe,
        net_load.py:88-101) — the protobuf is parsed by the in-repo wire
        codec, no caffe runtime needed. Map a caffe BatchNorm AND its Scale
        layer to the same zoo BatchNormalization via ``name_map``."""
        from analytics_zoo_tpu_torch.caffe_import import load_caffe_weights

        return load_caffe_weights(model, weights_path, name_map=name_map,
                                  strict=strict)

    @staticmethod
    def load_torch(weights_path, model, name_map=None, strict: bool = True):
        """Pour a torch ``state_dict`` (a file, or a dict of tensors, on the
        card or in bf16 too) into a built zoo model (ref Net.load_torch,
        net_load.py:120-135) — torch module prefixes map to zoo layer names
        (optionally via ``name_map``) with layout converters per layer
        type. For full-module (TorchScript) exports, convert to ONNX and
        use Net.load_onnx."""
        from analytics_zoo_tpu_torch.torch_import import load_torch_weights

        return load_torch_weights(model, weights_path, name_map=name_map,
                                  strict=strict)
