"""The comparison that decides `correct`: a timed frame's pixels against
the plain reference's at the same pixels.

  rel_l1      the sum over the compared pixels and channels of |port -
              reference|, over the sum of |reference|: a bias or a lost
              share of the samples moves it;
  bad_px_pct  the share of compared pixels, in percent, where some channel
              differs by more than 1% of the reference's largest channel
              plus 0.01: a few pixels gone wrong move it.

Each is held to its configuration's limit (configs/<name>.json, "check");
a reading that is not finite fails.
"""
from __future__ import annotations

import math

import numpy as np

NAMES = ("rel_l1", "bad_px_pct")


def readings(port, ref):
    """port, ref: [P,3] pixels -> {name: reading}."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    diff = np.abs(port - ref)
    denom = float(np.abs(ref).sum())
    rel = diff.max(-1) / (np.abs(ref).max(-1) + 1e-2)
    return {"rel_l1": float(diff.sum() / denom) if denom > 0 else math.inf,
            "bad_px_pct": 100.0 * float((~(rel <= 1e-2)).mean())}


def judge(port, ref, limits):
    """-> (correct, {name: {"value", "limit"}})."""
    got = readings(port, ref)
    out = {k: {"value": got[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
