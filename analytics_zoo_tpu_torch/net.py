"""Model import surface (port of ``analytics_zoo_tpu.net``) — ref
pipeline/api/net/NetUtils.scala:142-212 and pyzoo ``Net.load*`` family
(net_load.py:70-160: bigdl/torch/caffe/keras/TF).

The loaders here need neither TensorFlow nor h5py to import. These forms
need neither at call time either: ONNX graphs
(:mod:`analytics_zoo_tpu_torch.onnx`), this framework's own saved models
and weights, a frozen TF ``.pb`` (:mod:`analytics_zoo_tpu_torch.tfnet`,
parsed by the in-repo GraphDef reader), a Keras ``to_json()``
architecture (:mod:`analytics_zoo_tpu_torch.keras_convert`), a torch
``state_dict`` and a ``.caffemodel``. These import a package at call
time and raise its ``ImportError`` without it: a SavedModel directory or
a Keras model file through ``load_tf`` (TensorFlow, to freeze it), and a
Keras HDF5 file (h5py), whole-model or weights. The GraphNet
transfer-learning surface (freeze/freeze_up_to/new_graph,
NetUtils.scala:221-280) lives on
:class:`analytics_zoo_tpu_torch.keras.engine.topology.Model` itself,
re-exported here as ``GraphNet``.
"""

from __future__ import annotations

import os
from typing import Any

from analytics_zoo_tpu_torch.keras.engine.topology import Model as GraphNet  # noqa: F401 (re-export)


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
        """Run someone else's trained TF model natively (ref TFNet.scala:52,
        net_load.py:120-160). Accepts a SavedModel directory, a frozen
        ``.pb`` GraphDef (requires ``input_names``/``output_names``), or a
        Keras ``.h5``/``.keras`` model file. The graph is interpreted once
        into a function of PyTorch ops (weights frozen as constants) and
        returned as a :class:`analytics_zoo_tpu_torch.tfnet.TFNet` layer —
        stack a head on it for transfer learning. A ``.pb`` is read
        without TensorFlow; a SavedModel or a Keras file needs it at load
        time (to freeze the variables) and raises its ``ImportError``
        without it."""
        from analytics_zoo_tpu_torch import tfnet

        return tfnet.TFNet(tfnet.load(path, input_names, output_names,
                                      caller="load_tf"))

    @staticmethod
    def load_keras(path: str, model=None, by_name: bool = True,
                   strict: bool = True):
        """Load a pre-trained Keras model (ref Net.load_keras,
        net_load.py:153-164). Two forms:

        - ``load_keras(json_path, hdf5_path)`` — the reference signature:
          the architecture comes from a ``model.to_json()`` file (parsed by
          :mod:`analytics_zoo_tpu_torch.keras_convert` into zoo layers;
          no TensorFlow, and no h5py without a weights file), weights from
          the optional HDF5 file. Returns the built zoo model.
        - ``load_keras(hdf5_path)`` — a lone whole-model HDF5 (from
          ``model.save``): the architecture is read from the file's
          ``model_config`` attribute, weights from the same file — the
          reference's architecture-in-h5 form (net_load.py:153).
        - ``load_keras(weights_path, model)`` — pour an HDF5 *weight* file
          into an already-built zoo model, by layer name with per-type
          layout converters. Returns the imported layer names.

        Note: ``by_name`` defaults to ``True`` here (the reference defaults
        to ``False``). Zoo layer names are preserved 1:1 by the converter,
        so name matching is the robust default; pass ``by_name=False`` for
        positional matching of a rebuilt architecture.
        """
        from analytics_zoo_tpu_torch.keras_import import load_keras_weights

        if model is None or isinstance(model, str):
            import json as jsonlib

            from analytics_zoo_tpu_torch.keras_convert import (
                convert_keras_architecture)

            with open(path, "rb") as f:
                magic = f.read(8)
            if magic[:4] == b"PK\x03\x04":
                raise NotImplementedError(
                    f"load_keras: '{path}' is a Keras-3 native .keras zip "
                    "archive, which this loader does not parse — save the "
                    "source model as legacy HDF5 (model.save('m.h5')) or "
                    "pass its to_json() architecture plus a weights file")
            if magic == b"\x89HDF\r\n\x1a\n":
                # whole-model HDF5 as the FIRST argument (reference's
                # hdf5-alone form) — architecture rides in model_config
                if model is not None:
                    raise ValueError(
                        "load_keras: first argument is an HDF5 file — for "
                        "the (json_path, hdf5_path) form the architecture "
                        "json must come first")
                import h5py

                with h5py.File(path, "r") as hf:
                    raw = hf.attrs.get("model_config")
                if raw is None:
                    raise ValueError(
                        f"load_keras: '{path}' is an HDF5 weight file with "
                        "no model_config attribute — pass the to_json() "
                        "architecture file first: load_keras(json_path, "
                        f"'{path}')")
                spec = jsonlib.loads(
                    raw.decode() if isinstance(raw, bytes) else raw)
                weights_path = path
            else:
                with open(path) as f:
                    spec = jsonlib.load(f)
                weights_path = model  # hdf5_path (may be None)
            zmodel = convert_keras_architecture(
                spec.get("config", spec), spec.get("class_name"))
            if weights_path:
                load_keras_weights(zmodel, weights_path, by_name=by_name,
                                   strict=strict)
            return zmodel
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
