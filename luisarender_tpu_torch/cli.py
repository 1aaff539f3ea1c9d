"""Command-line renderer.

Counterpart of luisarender_tpu/cli.py (LuisaRender's src/apps/cli.cpp:
154-185): parse the command line (-D key=value defines, output override),
load the scene (JSON or .luisa text SDL), compile it onto the first CUDA
card, render every camera, save the images.

    python -m luisarender_tpu_torch.cli scene.json [-D key=value ...] [-o out.exr]
        [--profile trace.json]

`main(argv, device=None)` renders on `device` (default: the first CUDA card;
it raises without one); the command line has no device flag, as the
reference's has none. `--profile FILE` renders under torch.profiler (the
host, and the card where the render runs on one) and writes its Chrome
trace to FILE: the port's `lr.*` spans (core/trace.py) beside the
operators and kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import time


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(
        prog="luisarender-tpu-torch",
        description="Monte-Carlo renderer on PyTorch and CUDA",
    )
    parser.add_argument("scene", help="scene file (.json or .luisa)")
    parser.add_argument(
        "-D",
        "--define",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="text-SDL macro override (repeatable)",
    )
    parser.add_argument(
        "-o", "--output", default=None, help="override the first camera's output file"
    )
    parser.add_argument(
        "--spp", type=int, default=None, help="override samples per pixel"
    )
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="verbose logging"
    )
    parser.add_argument(
        "--profile", default=None, metavar="FILE",
        help="write a Chrome trace of the render (torch.profiler) to FILE",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    logging.getLogger("luisarender_tpu_torch").setLevel(logging.INFO)

    macros = {}
    for d in args.define:
        if "=" not in d:
            parser.error(f"invalid -D '{d}' (expected KEY=VALUE)")
        k, v = d.split("=", 1)
        macros[k] = v

    import luisarender_tpu_torch as lt

    # the device first: without a card this raises before any work
    dev = lt.resolve_device(device)
    t0 = time.time()
    scene = lt.load_scene(args.scene, macros)
    if args.output is not None:
        scene.cameras[0].file = args.output
    if args.spp is not None:
        for cam in scene.cameras:
            cam.spp = args.spp
    print(f"scene loaded in {time.time() - t0:.2f}s", file=sys.stderr)

    t0 = time.time()
    compiled = lt.compile_scene(scene, device=dev)
    print(
        f"compiled {compiled.plan.num_tris} tris, "
        f"{compiled.plan.num_instances} instances in {time.time() - t0:.2f}s",
        file=sys.stderr,
    )

    prof = contextlib.nullcontext()
    if args.profile is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
    t0 = time.time()
    with prof:
        results = scene.integrator.render(compiled, save=True)
    print(f"rendered in {time.time() - t0:.2f}s", file=sys.stderr)
    if args.profile is not None:
        prof.export_chrome_trace(args.profile)
        print(f"profile written to {args.profile}", file=sys.stderr)
    for path in results:
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
