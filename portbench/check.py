"""What decides ``correct``: the numbers compared between the program's
readings and the reference's, and their limits.

A training cell's readings (``train_readings`` of a reference, the
entry's of the program) are each checked step's loss, each leaf's
gradient norm at the first step, as the optimizer got it, and each
leaf's change after the checked steps. Three numbers come of them:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the worst leaf's gap between the two gradient norms, over
  the larger of the reference's norm of that leaf and of the median
  leaf;
- ``change``: the same of the change, over the leaves whose reference
  gradient is at least ``NOUGHT`` of the median leaf's (a leaf with a
  gradient that is nought to rounding moves under AdamW by round-off
  alone).
"""
from __future__ import annotations

import math
import statistics

#: A leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of ``change``.
NOUGHT = 1e-3


def _gap(ours: dict, ref: dict, keep) -> float:
    floor = statistics.median(ref[n] for n in keep)
    return max(abs(ours[n] - ref[n]) / max(ref[n], floor, 1e-30)
               for n in keep)


def numbers(ours: dict, ref: dict) -> dict:
    """``{"loss", "grad", "change"}`` of the readings ``ours`` against
    the reference's ``ref``. A reading that is not finite reads inf."""
    vals = [*ours["loss"], *ours["grad"].values(), *ours["change"].values()]
    if not all(math.isfinite(v) for v in vals):
        return {"loss": math.inf, "grad": math.inf, "change": math.inf}
    loss = max(abs(a - b) / abs(b) for a, b in zip(ours["loss"],
                                                    ref["loss"]))
    g_ref = ref["grad"]
    g_floor = statistics.median(g_ref.values())
    moved = [n for n in g_ref if g_ref[n] >= NOUGHT * g_floor]
    return {"loss": loss, "grad": _gap(ours["grad"], g_ref, list(g_ref)),
            "change": _gap(ours["change"], ref["change"], moved)}


def worst(rows: list) -> dict:
    """Each number's largest value over several readings (the ranks)."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def verdict(nums: dict, limits: dict, launches: dict) -> tuple:
    """``(correct, compared)``: every number at or under its limit, and
    the attention kernels launched forward and backward in the window
    at least once per layer per step; ``compared`` has each number
    beside its limit."""
    compared = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    compared["attn_fwd_launches"] = {"value": launches["fwd"],
                                     "limit": launches["least"]}
    compared["attn_bwd_launches"] = {"value": launches["bwd"],
                                     "limit": launches["least"]}
    ok = all(nums[k] <= limits[k] for k in limits) \
        and launches["fwd"] >= launches["least"] > 0 \
        and launches["bwd"] >= launches["least"]
    return ok, compared
