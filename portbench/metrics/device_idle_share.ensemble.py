"""``device_idle_share.train`` of a seed-ensemble cell, which reports
``ensemble_samples_per_s``: the same reader."""
from portbench.harness import load_reader

read = load_reader("device_idle_share.train")
