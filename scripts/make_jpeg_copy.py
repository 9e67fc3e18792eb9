#!/usr/bin/env python3
"""Copy an NDDS dataset with its PNG frames re-encoded as JPEG, by PIL.

Test data for the JPEG route of the PyTorch port's image loader: every
``*.png`` of SRC becomes ``*.jpg`` in DST (PIL, ``--quality``, chroma
subsampling 4:2:0 by default; ``--progressive`` writes progressive files,
libjpeg's standard 10-scan script), every other file is copied as it is.  With
``--decoded PATH.npy`` PIL's own decode of each JPEG it wrote (``convert(
"RGB")``), in the sorted order of the file names, is saved beside it as one
``[N, H, W, 3]`` uint8 array, the reference the loader is held to.  This
script imports PIL; the port does not.

Usage:
  python3 scripts/make_jpeg_copy.py SRC DST [--quality 90] [--subsampling 2]
      [--progressive] [--decoded DST/pil_decoded.npy]
"""

import argparse
import os
import shutil

import numpy as np
from PIL import Image


def make_jpeg_copy(src, dst, quality=90, subsampling=2, decoded=None, progressive=False):
    os.makedirs(dst, exist_ok=True)
    frames = []
    for name in sorted(os.listdir(src)):
        path = os.path.join(src, name)
        if name.endswith(".png"):
            out = os.path.join(dst, name[:-4] + ".jpg")
            with Image.open(path) as im:
                im.convert("RGB").save(out, quality=quality, subsampling=subsampling, progressive=progressive)
            if decoded:
                with Image.open(out) as im:
                    frames.append(np.asarray(im.convert("RGB")))
        elif os.path.isfile(path):
            shutil.copyfile(path, os.path.join(dst, name))
    if decoded:
        np.save(decoded, np.stack(frames))
    return len(frames)


def main():
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--quality", type=int, default=90)
    parser.add_argument("--subsampling", type=int, default=2, help="PIL's: 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0")
    parser.add_argument("--progressive", action="store_true", help="Write progressive JPEGs.")
    parser.add_argument("--decoded", default=None, help="Where to save PIL's decode of the JPEGs (.npy).")
    args = parser.parse_args()
    n = make_jpeg_copy(args.src, args.dst, args.quality, args.subsampling, args.decoded, args.progressive)
    print(f"{n} frames written as JPEG to {args.dst}")


if __name__ == "__main__":
    main()
