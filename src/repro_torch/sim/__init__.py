"""Synthetic study data (the solver waits for a later slice)."""
