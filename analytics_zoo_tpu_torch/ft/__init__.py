"""Fault tolerance (port of ``analytics_zoo_tpu.ft``): the atomic
checkpoint commit protocol, its failure points, the asynchronous
checkpoint manager and preemption handling."""
