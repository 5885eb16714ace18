"""Render statistics (port of pbrt_tpu/utils/stats.py).

The integrators count live rays and hits on the device (their counters
dicts, integrators/path.py COUNTERS); the drivers merge them, summed over
passes (and over ranks in a sharded render), into the host-side STATS,
beside their own figures, and the CLI's --stats prints STATS.format(): the
reference's "Category/Name" report, letter for letter.
"""
from __future__ import annotations

import collections
from typing import Dict

import numpy as np


class StatsAccumulator:
    """Named counters, distributions and ratios of a render."""

    def __init__(self):
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.distributions: Dict[str, list] = collections.defaultdict(
            lambda: [0.0, 0.0, float("inf"), float("-inf")])  # sum n min max
        self.ratios: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0.0])

    def report_counter(self, title: str, value):
        self.counters[title] += float(value)

    def report_distribution(self, title: str, values):
        v = np.asarray(values, np.float64).ravel()
        d = self.distributions[title]
        d[0] += float(v.sum())
        d[1] += float(v.size)
        d[2] = min(d[2], float(v.min()) if v.size else d[2])
        d[3] = max(d[3], float(v.max()) if v.size else d[3])

    def report_ratio(self, title: str, num, denom):
        r = self.ratios[title]
        r[0] += float(num)
        r[1] += float(denom)

    def clear(self):
        self.counters.clear()
        self.distributions.clear()
        self.ratios.clear()

    def format(self) -> str:
        """The report: "Statistics:", then each category and its lines."""
        by_cat = collections.defaultdict(list)
        for title, v in sorted(self.counters.items()):
            cat, _, name = title.partition("/")
            by_cat[cat].append(f"    {name:<42} {v:,.0f}")
        for title, (s, n, lo, hi) in sorted(self.distributions.items()):
            cat, _, name = title.partition("/")
            avg = s / n if n else 0.0
            by_cat[cat].append(
                f"    {name:<42} {avg:.3f} avg [range {lo:.3f} - {hi:.3f}]")
        for title, (num, den) in sorted(self.ratios.items()):
            cat, _, name = title.partition("/")
            pct = 100.0 * num / den if den else 0.0
            by_cat[cat].append(f"    {name:<42} {num:,.0f} / {den:,.0f} ({pct:.2f}%)")
        out = ["Statistics:"]
        for cat in sorted(by_cat):
            out.append(f"  {cat}")
            out.extend(by_cat[cat])
        return "\n".join(out)


STATS = StatsAccumulator()


def merge_device_counters(host_stats: StatsAccumulator, counters: dict):
    """Report an integrator's counters (ints or device scalars, summed)."""
    host_stats.report_counter("Intersections/Camera rays traced", counters["camera_rays"])
    host_stats.report_counter("Intersections/Shadow rays traced", counters["shadow_rays"])
    host_stats.report_counter("Intersections/Bounce rays traced", counters["bounce_rays"])
    host_stats.report_counter("Intersections/Valid hits", counters["valid_hits"])
    host_stats.report_counter("Integrator/Paths terminated by RR",
                              counters["paths_terminated_rr"])
    if "glossy_hits" in counters:
        host_stats.report_counter("Integrator/Glossy hits", counters["glossy_hits"])
