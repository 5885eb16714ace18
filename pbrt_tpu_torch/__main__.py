"""CLI: python -m pbrt_tpu_torch [--device cuda|cpu] [--outfile F]
[--cropwindow X0 X1 Y0 Y1] [--quick] scene.pbrt ...

Renders each scene with the PyTorch port, on the card unless --device cpu
is given. On the card the BVH and instance walks run the CUDA kernels
(built at first use); with no card it raises: there is no CPU fallback.
A scene that fails to render is logged to stderr as `error rendering PATH:
ERROR` and the next one is rendered (the reference's log and continue).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch",
                                 description="PyTorch/CUDA port of the pbrt_tpu renderer")
    ap.add_argument("scenes", nargs="+", help=".pbrt scene files")
    ap.add_argument("--device", default="cuda", help="torch device: cuda[:i] or cpu")
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

    import torch
    from pbrt_tpu_torch.render import Options, render_file
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device "
                           "(torch.cuda.is_available() is false); pass --device cpu")
    opts = Options(quick=args.quick, outfile=args.outfile,
                   crop_window=tuple(args.cropwindow) if args.cropwindow else None,
                   wavefront_size=args.wavefront, seed=args.seed)
    for path in args.scenes:
        t0 = time.time()
        try:
            out, _ = render_file(path, opts, device=device)
        except Exception as e:  # noqa: BLE001 - log and continue, as the reference does
            print(f"error rendering {path}: {e}", file=sys.stderr)
            continue
        if not args.quiet:
            print(f"{path} -> {out}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
