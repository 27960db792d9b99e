"""The comparison that decides ``correct``.

A cell's ``limits/<cell>.json`` names the numbers compared and the limit of
each; its driver returns a reading of each, and ``judge`` holds every
reading to its limit. What follows is the training cells' readings.

Both sides are summarised the same way: each of the first updates' loss,
the first update's gradient norm by leaf as the optimizer gets it (after
the clip), and each leaf's change in norm after the last update. Three
numbers compare them, each the worst over steps or leaves:

- ``loss_gap``: the largest relative gap between the two losses of a step;
- ``grad_gap``: the largest gap between the two norms of a leaf's first
  gradient, over the larger of the reference's norm of that leaf and of
  the median leaf (some gradients are all but zero);
- ``change_gap``: the same of the leaves' change, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (the
  others move by round-off alone under Adam).

A number that is not finite reads infinite.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
KEEP_FRACTION = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def readings(got: Optional[Dict], ref: Dict,
             worst: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """The three numbers of ``got`` against ``ref`` (each as
    ``reference.rgcn.train_steps`` returns it); all infinite when ``got``
    is None (the program gave no numbers). ``worst``, when given, gets the
    step or leaf that each number comes from."""
    if got is None:
        return {k: math.inf for k in NUMBERS}
    loss = {f"step {i + 1}": _finite(abs(g - r) / abs(r))
            for i, (g, r) in enumerate(zip(got["loss"], ref["loss"]))}
    rg = ref["grad1"]
    med = statistics.median(rg.values())
    grad = {n: _finite(abs(got["grad1"][n] - rg[n]) / max(rg[n], med))
            for n in rg}
    kept = [n for n in rg if rg[n] >= KEEP_FRACTION * med]
    rc = ref["change"]
    med_c = statistics.median(rc[n] for n in kept)
    change = {n: _finite(abs(got["change"][n] - rc[n]) / max(rc[n], med_c))
              for n in kept}
    out = {}
    for name, gaps in zip(NUMBERS, (loss, grad, change)):
        where = max(gaps, key=gaps.get)
        out[name] = gaps[where]
        if worst is not None:
            worst[name] = where
    if worst is not None:
        worst["left_out"] = ",".join(n for n in rg if n not in kept) or "none"
    return out


def unmatched(read: Dict[str, float], limits: Dict[str, float]) -> str:
    """What keeps ``read`` and ``limits`` from naming the same numbers:
    empty where each reading has a limit and each limit a reading."""
    extra = sorted(set(read) - set(limits))
    missing = sorted(set(limits) - set(read))
    return "; ".join(
        f"{what}: {', '.join(names)}" for what, names in (
            ("readings without a limit", extra),
            ("limits without a reading", missing)) if names)


def judge(read: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number that ``limits`` names is at or under its
    limit (the two name the same numbers: ``unmatched``)."""
    if unmatched(read, limits):
        raise ValueError(unmatched(read, limits))
    return all(read[k] <= limits[k] for k in limits)
