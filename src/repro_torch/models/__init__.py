"""Surrogate model layers and the DCGAN surrogate."""
