#!/usr/bin/env python3
"""Time the port's host image loader on baseline and progressive JPEG.

Writes ``--frames`` seeded 640x480 frames (a smooth scene with noise) as
quality-90 4:2:0 JPEG with PIL, once baseline and once progressive
(libjpeg's 10-scan script), builds the loader into a temporary directory
(timed), checks that each progressive frame decodes to the pixels of its
baseline twin, and prints one JSON line: the least ms a frame over
``--reps`` calls of ``decode_batch`` at 1 and 8 threads, by kind, with
the mean file size.  This script imports PIL to write the files; the port
does not.

Usage:
  python3 scripts/time_jpeg_decode.py [--frames 16] [--reps 5]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dream_tpu_torch.data import native_loader  # noqa: E402
from dream_tpu_torch.ops import cuda_build  # noqa: E402


def scene(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def main():
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.BUILD_DIR = Path(tmp) / "build"
        t0 = time.perf_counter()
        cuda_build.build(native_loader.LIBRARY)
        result = {"build_s": time.perf_counter() - t0}
        paths = {"baseline": [], "progressive": []}
        for i in range(args.frames):
            image = Image.fromarray(scene(480, 640, i))
            for kind in paths:
                paths[kind].append(os.path.join(tmp, f"{kind}_{i}.jpg"))
                image.save(paths[kind][-1], quality=90, subsampling=2, progressive=kind == "progressive")
        decoded = {kind: native_loader.decode_batch(p, 480, 640, 8) for kind, p in paths.items()}
        result["progressive_equal_to_baseline"] = int(sum(
            np.array_equal(a, b) for a, b in zip(decoded["baseline"], decoded["progressive"])))
        for kind, p in paths.items():
            result[kind] = {"bytes_a_frame": float(np.mean([os.path.getsize(f) for f in p]))}
            for threads in (1, 8):
                best = min(_seconds(p, threads) for _ in range(args.reps))
                result[kind][f"ms_a_frame_{threads}_thread{'s' if threads > 1 else ''}"] = best / len(p) * 1e3
    print(json.dumps(result))


def _seconds(paths, threads):
    t0 = time.perf_counter()
    native_loader.decode_batch(paths, 480, 640, threads)
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
