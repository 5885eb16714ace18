"""Run one cell of the pbrt_tpu_torch benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
pbrt_tpu_torch package. The last line of standard output is the result's
JSON object; the numbers compared by the correctness check are also the
last lines of standard error. It needs a CUDA device, and exits non-zero
without printing a result where there is none, where the package is
missing, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of a run lives at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
