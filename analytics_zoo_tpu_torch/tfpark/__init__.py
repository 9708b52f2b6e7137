"""TFPark surfaces (port of ``analytics_zoo_tpu.tfpark``)."""
