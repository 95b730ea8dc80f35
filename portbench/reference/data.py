"""The conditions of a produced store, from its ``production.json``.

Each member's parameters as the provenance records them -> (atwood,
amplitude, mode, log10 diffusivity, (PCHIP seed mod 97) / 97, impulse),
repeated over the member's snapshots, with the normalised time
``linspace(0, 1, nsnaps)`` as the last entry (float32).
"""
from __future__ import annotations

import json
import os

import numpy as np


def conditions(scenario_dir: str) -> np.ndarray:
    with open(os.path.join(scenario_dir, "production.json")) as f:
        prov = json.load(f)
    nsnaps = next(s for s in prov["plan"]["scenarios"]
                  if s["name"] == prov["scenario"])["spec"]["nsnaps"]
    params = np.array([[s["atwood"], s["amplitude"], s["mode"], np.log10(s["diffusivity"]),
                        float(s["pchip_seed"] % 97) / 97.0, s["impulse"]]
                       for s in prov["sims"]], dtype=np.float32)
    t = np.linspace(0.0, 1.0, nsnaps, dtype=np.float32)
    return np.concatenate([np.repeat(params, nsnaps, axis=0),
                           np.tile(t, len(params))[:, None]], axis=1)
