"""Operators of the port: flash attention on hand-written CUDA kernels and
the fused softmax cross-entropy."""
