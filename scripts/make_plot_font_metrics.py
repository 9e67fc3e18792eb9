#!/usr/bin/env python3
"""Write dream_tpu_torch/utils/font_metrics.py: the horizontal metrics of
DejaVu Sans, matplotlib's default font, at 10 pt and 100 dpi, which the
port's line-chart renderer (dream_tpu_torch/utils/plot.py) lays its text
out with, so that its legend boxes and label positions are matplotlib's.

For each printable ASCII character: the advance (in 1/512 px: FreeType's
26.6 fixed point at matplotlib's horizontal hinting factor of 8) and the
glyph's ink box left and right edges (1/64 px), read with matplotlib's
FT2Font as its Agg renderer sets the font up.  It needs matplotlib; the port
reads the table and never imports matplotlib.  Run from the repository root:

    python3 scripts/make_plot_font_metrics.py
"""

import os

from matplotlib import font_manager, ft2font

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "dream_tpu_torch", "utils", "font_metrics.py")


def main():
    import matplotlib

    font = ft2font.FT2Font(font_manager.findfont("DejaVu Sans"), hinting_factor=8)
    font.set_size(10, 100)
    rows = []
    for code in range(32, 127):
        glyph = font.load_char(code)
        rows.append((code, glyph.horiAdvance, glyph.bbox[0], glyph.bbox[2]))
    lines = [
        '"""DejaVu Sans horizontal metrics at 10 pt and 100 dpi, as matplotlib lays text out.',
        "",
        "Made by ``scripts/make_plot_font_metrics.py`` with matplotlib "
        f"{matplotlib.__version__}; do not edit by hand.",
        ":data:`METRICS` maps a character code to (advance in 1/512 px, ink box left",
        "and right edges in 1/64 px).",
        '"""',
        "",
        "METRICS = {",
    ]
    for i in range(0, len(rows), 4):
        lines.append("    " + " ".join(f"{c}: ({a}, {x0}, {x1})," for c, a, x0, x1 in rows[i:i + 4]))
    lines.append("}")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
