"""Model zoo (port of ``analytics_zoo_tpu.models``): the image
classifiers ResNet-50 and LeNet-5 so far."""
