"""Model zoo (port of ``analytics_zoo_tpu.models``): the ``ZooModel`` base,
the image classifiers ResNet-50 and LeNet-5, the recommenders NeuralCF and
Wide & Deep, ``TextClassifier`` and ``Seq2seq`` so far."""
