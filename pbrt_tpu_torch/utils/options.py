"""Run-shape options of a render (port of pbrt_tpu/utils/options.py: the
fields the renderer reads; the reference's thread and tile flags become
the wavefront size and the number of ranks)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Options:
    quick: bool = False          # a quarter of the resolution and of the samples
    quiet: bool = False
    outfile: str = ""            # in place of the Film's "filename"
    crop_window: Optional[Tuple[float, float, float, float]] = None
    sppm_radius: float = 0.0     # over 0: SPPM's initial radius, in place of the scene's
    wavefront_size: int = 1 << 17   # lanes a pass (a rank's, in a sharded render)
    devices: int = 0             # over 1: shard a sampler integrator's render over ranks
    seed: int = 0
    # write the image so far every N passes (0: never), to preview_path or
    # else the output file
    preview_every: int = 0
    preview_path: str = ""
    # the film and the sample cursor are the whole state of a render, so a
    # checkpoint (every N passes, 0: never) resumes it exactly
    checkpoint_path: str = ""
    checkpoint_every: int = 0
    resume: bool = False         # start from checkpoint_path where it holds a checkpoint
    stats_device: bool = True    # merge the integrators' device counters into STATS
