"""Codec kernels: CUDA on the card, plain PyTorch versions on the CPU."""
