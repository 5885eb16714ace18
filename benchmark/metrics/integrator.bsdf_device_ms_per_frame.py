"""integrator.bsdf_device_ms_per_frame: device time of the operations
launched inside li_path's li.lobes and li.bsdf spans (the lobes, BSDF
sampling and the throughput update; their sampler draws count under
`sampler`) a traced frame, in ms (spans.py)."""
from spans import device_ms_in


def read(ctx):
    return device_ms_in(ctx, ("li.lobes", "li.bsdf"))
