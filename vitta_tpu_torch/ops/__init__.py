"""Ops of the port: statistics, losses and the CUDA kernels."""
