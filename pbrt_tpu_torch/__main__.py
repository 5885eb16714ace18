"""CLI: python -m pbrt_tpu_torch [--device cuda|cpu] [--outfile F]
[--cropwindow X0 X1 Y0 Y1] [--quick] scene.pbrt ...

Renders each scene with the PyTorch port. With --device cuda the BVH walk
runs the CUDA kernel (built at first use); there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch",
                                 description="PyTorch/CUDA port of the pbrt_tpu renderer")
    ap.add_argument("scenes", nargs="+", help=".pbrt scene files")
    ap.add_argument("--device", default="cpu", help="torch device: cpu or cuda[:i]")
    ap.add_argument("--outfile", default="", help="override the output filename")
    ap.add_argument("--cropwindow", nargs=4, type=float, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"))
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution, a quarter of the samples")
    ap.add_argument("--wavefront", type=int, default=1 << 17,
                    help="lanes per wavefront pass")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from pbrt_tpu_torch.render import Options, render_file
    opts = Options(quick=args.quick, outfile=args.outfile,
                   crop_window=tuple(args.cropwindow) if args.cropwindow else None,
                   wavefront_size=args.wavefront, seed=args.seed)
    for path in args.scenes:
        t0 = time.time()
        out, _ = render_file(path, opts, device=args.device)
        if not args.quiet:
            print(f"{path} -> {out}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
