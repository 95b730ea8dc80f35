"""PyTorch + CUDA port of the reproduction (see repro/ for the JAX reference)."""
