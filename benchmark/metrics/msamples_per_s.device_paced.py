"""msamples_per_s.device_paced: msamples_per_s in the cells whose frames
the device paces, where the rate spreads far less than in a host-paced
cell and so can hold a tight bound of its own (host clock)."""
from pathlib import Path

import plugins

read = plugins.load("metrics", "msamples_per_s", Path(__file__).resolve().parent.parent).read
