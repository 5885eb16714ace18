"""CLI: python -m pbrt_tpu_torch [--device cuda|cpu] [--outfile F]
[--cropwindow X0 X1 Y0 Y1] [--quick] [--sppm-radius R] [--stats]
[--preview N] [--checkpoint PATH] [--checkpoint-every N] [--resume]
[--devices N] scene.pbrt ...

Renders each scene with the PyTorch port, on the card unless --device cpu
is given. On the card the BVH and instance walks run the CUDA kernels
(built at first use); with no card it raises: there is no CPU fallback.
A scene that fails to render is logged to stderr as `error rendering PATH:
ERROR` and the next one is rendered (the reference's log and continue).
--stats prints the statistics report after each scene, with a Timing
category: each utils/trace.py span's host time a frame less the time of
the spans nested in it ("Timing/render.pass self ms", "Timing/li.bsdf
self ms", "Timing/sampler self ms", ...), recorded only under --stats. The
host issues the device's work without waiting for it, so a stage's time is
its issue time plus, where it copies host data to the device or reads a
device value back, its wait for the device to catch up. --preview writes the
image so far every N passes; --checkpoint saves the film every
--checkpoint-every passes and --resume starts from it; --devices shards a
sampler integrator's render over N ranks (on CUDA one a card, as many as
there are).
"""
from __future__ import annotations

import argparse
import contextlib
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
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over N ranks (on CUDA one a card, as many as there are)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sppm-radius", type=float, default=0.0,
                    help="SPPM's initial photon radius (over 0: in place of the scene's)")
    ap.add_argument("--stats", action="store_true", help="print statistics")
    ap.add_argument("--preview", type=int, default=0, metavar="N",
                    help="write the in-progress image every N passes")
    ap.add_argument("--checkpoint", default="", metavar="PATH",
                    help="checkpoint file (.npz) for save/resume")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a checkpoint every N passes")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from pbrt_tpu_torch.render import render_file
    from pbrt_tpu_torch.utils.options import Options
    from pbrt_tpu_torch.utils.stats import STATS
    from pbrt_tpu_torch.utils.trace import recording, report_timing, take
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device "
                           "(torch.cuda.is_available() is false); pass --device cpu")
    opts = Options(quick=args.quick, quiet=args.quiet, outfile=args.outfile,
                   crop_window=tuple(args.cropwindow) if args.cropwindow else None,
                   wavefront_size=args.wavefront, seed=args.seed,
                   sppm_radius=args.sppm_radius, devices=args.devices,
                   preview_every=args.preview, checkpoint_path=args.checkpoint,
                   checkpoint_every=args.checkpoint_every, resume=args.resume)
    for path in args.scenes:
        t0 = time.time()
        try:
            with recording() if args.stats else contextlib.nullcontext():
                out, _ = render_file(path, opts, device=device, verbose=not args.quiet)
        except Exception as e:  # noqa: BLE001 - log and continue, as the reference does
            print(f"error rendering {path}: {e}", file=sys.stderr)
            take()
            continue
        if not args.quiet:
            print(f"{path} -> {out}  ({time.time() - t0:.1f}s)")
        if args.stats:
            report_timing(STATS, take())
            print(STATS.format())
            STATS.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
