"""Faults planted under the timed path, for showing that the check catches
them (control.py, the tests): each patches a name of the port's render
module for the length of a `with` block and restores it after.

  unchanged     the film's deposit returns the film unchanged (a step that
                returns its state as it was): the image stays black;
  half_dropped  the samples of odd sample indices get weight 0, so each
                pixel is the mean over the other half;
  altered       the radiance of one lane in 61 is scaled by 1.5 where the
                integrator produces it.

A frame runs on one device, so there is no exchange between chips to leave
out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_dropped", "altered")


@contextlib.contextmanager
def planted(fault):
    import torch
    from pbrt_tpu_torch import render as R
    saved = {"add_samples": R.add_samples, "li_fn": R.li_fn}
    li_fn = saved["li_fn"]
    if fault == "unchanged":
        R.add_samples = lambda spec, state, *args: state
    elif fault == "half_dropped":
        def fn(cs):
            li = li_fn(cs)

            def wrapped(cs_, px, py, sample_idx, *args, **kw):
                L, p_film, ray_w, cnt = li(cs_, px, py, sample_idx, *args, **kw)
                return L, p_film, ray_w * (sample_idx % 2 == 0).to(ray_w.dtype), cnt
            return wrapped
        R.li_fn = fn
    elif fault == "altered":
        def fn(cs):
            li = li_fn(cs)

            def wrapped(*args, **kw):
                L, p_film, ray_w, cnt = li(*args, **kw)
                scale = torch.where(torch.arange(L.shape[0], device=L.device) % 61 == 0, 1.5, 1.0)
                return L * scale[:, None].to(L.dtype), p_film, ray_w, cnt
            return wrapped
        R.li_fn = fn
    else:
        raise KeyError(fault)
    try:
        yield
    finally:
        R.add_samples, R.li_fn = saved["add_samples"], saved["li_fn"]
