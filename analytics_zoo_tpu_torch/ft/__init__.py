"""Fault tolerance (port of ``analytics_zoo_tpu.ft``): the atomic
checkpoint commit protocol, its failure points, the asynchronous
checkpoint manager, preemption handling, and multi-host training's
rendezvous, sharded optimizer update and two-phase sharded commit
(``distributed``)."""
