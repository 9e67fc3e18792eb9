#!/usr/bin/env python3
"""Write dream_tpu_torch/utils/text_atlas.py: the glyph coverage of OpenCV's
FONT_HERSHEY_SIMPLEX at scale 0.75 and thickness 2, the one text size
``dream_tpu/visualize.py`` draws (``cv2.putText`` at ``:135-139``).

OpenCV 5 draws Hershey text antialiased, one glyph after another at whole-
pixel advances, and blends the coverage over the image.  For each of the 95
printable ASCII characters this script draws the character alone on a black
canvas (its coverage, 0-255, and its offset from the text origin) and the
character followed by ``I`` (the advance: the shift of ``I`` that
reproduces the pair).  It needs OpenCV (``cv2``); the port reads the table
and never imports cv2.  Run from the repository root:

    python3 scripts/make_text_atlas.py
"""

import base64
import os
import zlib

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "dream_tpu_torch", "utils", "text_atlas.py")
FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 0.75, 2
ORG = (40, 60)
CANVAS = (120, 200)


def render(text):
    img = np.zeros(CANVAS, np.uint8)
    cv2.putText(img, text, ORG, FONT, SCALE, 255, THICKNESS)
    return img


def advance(ch, single, marker):
    pair = render(ch + "I")
    for dx in range(60):
        if np.array_equal(np.maximum(single, np.roll(marker, dx, axis=1)), pair):
            return dx
    raise RuntimeError(f"no whole-pixel advance reproduces {ch!r} followed by I")


def main():
    marker = render("I")
    index, blob = {}, bytearray()
    for code in range(32, 127):
        single = render(chr(code))
        ys, xs = np.nonzero(single)
        if len(ys):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            crop = single[y0:y1, x0:x1]
            blob += crop.tobytes()
            box = (int(x1 - x0), int(y1 - y0), int(x0 - ORG[0]), int(y0 - ORG[1]))
        else:
            box = (0, 0, 0, 0)
        index[code] = box + (advance(chr(code), single, marker),)
    data = base64.b64encode(zlib.compress(bytes(blob), 9)).decode()
    items = [f"{k}: {v}," for k, v in index.items()]
    entries = "\n".join("    " + " ".join(items[i:i + 4]) for i in range(0, len(items), 4))
    with open(OUT, "w") as f:
        f.write(f'''"""Glyph coverage of OpenCV's FONT_HERSHEY_SIMPLEX at scale 0.75, thickness 2.

Made by ``scripts/make_text_atlas.py`` with OpenCV {cv2.__version__} (each printable
ASCII character drawn alone with ``cv2.putText`` on a black canvas); do not
edit by hand.  :func:`glyphs` maps a character to its coverage (uint8
``[h, w]``, 255 = fully painted), the offset of the coverage's top-left
pixel from the text origin (x, y) and the pen's advance in pixels.
"""

import base64
import functools
import zlib

import numpy as np

FONT_SCALE = {SCALE}
THICKNESS = {THICKNESS}
OPENCV_VERSION = "{cv2.__version__}"

# Character code -> (width, height, x offset, y offset, advance).
_INDEX = {{
{entries}
}}

_DATA = (
{chr(10).join(f'    "{data[i:i + 88]}"' for i in range(0, len(data), 88))}
)


@functools.lru_cache(maxsize=1)
def glyphs():
    """Character -> (coverage, x offset, y offset, advance)."""
    raw = zlib.decompress(base64.b64decode(_DATA))
    out, pos = {{}}, 0
    for code, (w, h, ox, oy, adv) in _INDEX.items():
        alpha = np.frombuffer(raw, np.uint8, w * h, pos).reshape(h, w)
        out[chr(code)] = (alpha, ox, oy, adv)
        pos += w * h
    return out
''')
    print(f"wrote {OUT}: {len(index)} glyphs, {len(blob)} coverage bytes")


if __name__ == "__main__":
    main()
