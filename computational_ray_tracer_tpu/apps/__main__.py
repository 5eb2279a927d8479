"""CLI dispatcher: ``python -m computational_ray_tracer_tpu.apps <name>``
— the runtime equivalent of the reference's compile-time #define app
selection (main.cpp:3-14, main.cpp:56-109)."""

from __future__ import annotations

import argparse
import importlib
import sys

from computational_ray_tracer_tpu.apps import APP_NAMES


def main(argv=None):
    p = argparse.ArgumentParser(prog="computational_ray_tracer_tpu.apps",
                                description=__doc__)
    p.add_argument("app", choices=APP_NAMES)
    p.add_argument("--out", default="out", help="output directory")
    args, extra = p.parse_known_args(argv)
    from computational_ray_tracer_tpu.utils import compile_cache
    compile_cache.enable()
    mod = importlib.import_module(
        f"computational_ray_tracer_tpu.apps.{args.app}")
    return mod.main(outdir=args.out)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
