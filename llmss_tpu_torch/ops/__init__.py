"""Ops: layers, rope, attention (plain versions and dispatch), the CUDA
kernels K1 and K2, and sampling."""
