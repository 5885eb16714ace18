"""Reading torch.profiler's trace: the device events of a profile, the
port's walk kernels among them, their union in time and the idle gaps
named by the op that ends each.

`kernel_of` and `kernel_op` are frozen copies of the repository's
chip_smoke.py readers; the events come from the profiler's raw kineto
records, which cost far less to read than its FunctionEvent list.
"""
from __future__ import annotations

import re

# the walk kernels' functions in csrc/ and the route names they serve
WALK_KERNELS = ("walk_kernel", "traverse4_kernel", "instance_kernel", "kd_kernel")


def kernel_of(function):
    """A walk kernel's route name ("B1", "B5", ...) from its demangled
    function name as the profiler reports it, or None for any other
    device operation."""
    m = re.search(r"::(\w+_kernel)(?:<([^>]*)>)?", function)
    if m is None or m.group(1) not in WALK_KERNELS:
        return None
    named = {"traverse4_kernel": "B3", "instance_kernel": "B6", "kd_kernel": "K1"}
    if m.group(1) in named:
        return named[m.group(1)]
    flags = tuple(a.strip() in ("true", "1", "(bool)1") for a in (m.group(2) or "").split(","))
    return {(True, True, False): "B1", (True, True, True): "B2",
            (False, False, True): "B5"}.get(flags, "walk")


def kernel_op(name):
    """A device kernel's name shortened to the op it computes: the functor
    or lambda of an elementwise kernel ("Mul", "add", "bitwise_and"), else
    the kernel function's name."""
    for pattern in (r"(\w+)_kernel_cuda", r"Functor_(\w+)", r"::(\w+)Functor<",
                    r"(\w*kernel\w*)[<(]"):
        found = re.findall(pattern, name)
        if found:
            return found[-1]
    return name[:48]


def events(prof, device=True):
    """[(name, start_ns, duration_ns)] of a finished profile's device
    (or, device=False, host) events."""
    import torch
    want = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == want]


def union_ns(evs):
    """Total time covered by the events' intervals, overlaps counted once,
    and the gaps between them -> (busy ns, [(gap start, gap end)])."""
    spans = sorted((s, s + d) for _, s, d in evs)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def top_ops(evs, n=10):
    """The n device ops (kernel_op names) with the most time -> [[name,
    seconds]]."""
    by = {}
    for name, _, d in evs:
        k = kernel_op(name)
        by[k] = by.get(k, 0) + d
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_before(evs, n=10):
    """The device's idle gaps, each named by the device op that ended it
    (the op the host was issuing while the device waited), summed by
    kernel_op name -> the n largest as [[name, seconds]]."""
    spans = sorted((s, s + d, name) for name, s, d in evs)
    by, end = {}, None
    for s, e, name in spans:
        if end is not None and s > end:
            k = kernel_op(name)
            by[k] = by.get(k, 0) + (s - end)
        end = e if end is None else max(end, e)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
