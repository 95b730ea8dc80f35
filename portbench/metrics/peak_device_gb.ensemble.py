"""``peak_device_gb`` of a seed-ensemble cell, which reports ``ensemble_samples_per_s``:
the same reader."""
from portbench.harness import load_reader

read = load_reader("peak_device_gb")
