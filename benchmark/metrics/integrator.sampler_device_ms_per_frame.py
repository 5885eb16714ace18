"""integrator.sampler_device_ms_per_frame: device time of the operations
launched inside the port's `sampler` spans (sample_dim, sample_2d) a
traced frame, in ms (spans.py: the innermost span at each launch)."""
from spans import device_ms_in


def read(ctx):
    return device_ms_in(ctx, ("sampler",))
