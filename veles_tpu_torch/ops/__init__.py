"""Attention ops of the port: plain PyTorch paths and the CUDA kernels."""
