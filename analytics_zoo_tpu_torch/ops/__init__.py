"""Ops: the attention dispatcher and the hand-written CUDA kernels."""
