"""Keras-style layer and model API (port of ``analytics_zoo_tpu.keras``)."""
