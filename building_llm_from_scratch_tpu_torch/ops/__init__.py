"""Tensor operations: the plain math and the CUDA kernel wrappers."""
