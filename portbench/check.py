"""The numbers that decide ``correct`` for a training cell.

A run's readings (the program's, or the reference's put in its place) are
held to the reference's over the first steps, member by member:

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    gradient, over the larger of that leaf's reference norm and the
    median leaf's;
  * ``change_gap``: the same of the norms of the parameters' change after
    the first steps, over the leaves whose reference gradient is at least
    a thousandth of the median leaf's (a leaf whose gradient is nought to
    rounding moves under Adam by round-off alone).

A run whose readings lack a number (``train_ensemble`` exposes no
gradient; its timed call, only a logged loss) is held to the others.  The
ensemble's timed call gives ``window_loss_gap``, the loss gap of the step
it logs inside the window.  A number passes when it is at most its
limit.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

ZERO_GRAD_SHARE = 1e-3


def leaf_gaps(prog: dict, ref: dict, key: str) -> Dict[str, float]:
    """Each counted leaf's gap of ``key`` ("grad_norm" or "change_norm")."""
    p, r = prog[key], ref[key]
    med = statistics.median(r.values())
    leaves = list(r)
    if key == "change_norm":
        g = ref["grad_norm"]
        gmed = statistics.median(g.values())
        leaves = [k for k in leaves if g[k] >= ZERO_GRAD_SHARE * gmed]
    return {k: abs(p[k] - r[k]) / max(r[k], med) for k in leaves}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one member: ``prog`` and ``ref`` as
    ``reference.surrogate.train`` returns them (``prog`` may lack
    ``grad_norm`` and ``change_norm``)."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    if prog.get("grad_norm"):
        out["grad_gap"] = max(leaf_gaps(prog, ref, "grad_norm").values())
    if prog.get("change_norm"):
        out["change_gap"] = max(leaf_gaps(prog, ref, "change_norm").values())
    return out


def worst(members: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(m[k] for m in members) for k in members[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number with a limit; a number
    with no limit is an error in the cell's limits file."""
    missing = [k for k in numbers if k not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
