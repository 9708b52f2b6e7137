"""Serving runtime (port of ``analytics_zoo_tpu.inference``)."""

from analytics_zoo_tpu_torch.inference.inference_model import InferenceModel
