"""A small line-chart renderer on numpy: matplotlib's default figure, without matplotlib.

``dream_tpu``'s plots (``analysis.plot_train_valid_loss``, ``add_plots``,
``oks_plots``, ``scripts/analyze_training*.py``) draw with matplotlib, which
the port does not depend on (a GPU host need not have it).  :class:`Plot`
carries what those callers use, with matplotlib's geometry and numbers:

- the default figure, 6.4x4.8 in at 100 dpi (640x480 px), its axes at the
  subplot margins left 0.125, right 0.9, bottom 0.11, top 0.88;
- view limits: the data limits of every series (lines, error bars, filled
  bands) through ``Locator.nonsingular`` with 5% margins on each side
  (``Axes.autoscale_view``, ``axes.autolimit_mode: data``), or the
  ``xlim``/``ylim`` given (through the same ``nonsingular``);
- ticks as ``AutoLocator`` places them (``MaxNLocator`` with ``nbins`` from
  the axis length, 9 on this figure, and steps [1, 2, 2.5, 5, 10]), the
  visible ones those within the view limits;
- the default colour cycle (tab10), one cycle for lines and one for filled
  bands, as matplotlib keeps;
- lines in the styles ``-``, ``--``, ``:``, ``-.``, ``.`` markers (``.-``,
  ``.``) and none (``" "``), with ``linewidth`` and ``alpha``; ``errorbar``
  and ``fill_between``; the grid (``alpha``);
- a legend at ``lower right`` or ``best``: ``best`` takes matplotlib's rule
  (``Legend._find_best_position``): the least badness (data vertices
  inside the box, segments crossing it) over its ten anchored positions,
  the first of them on a tie.  Its box is laid out with DejaVu Sans's
  metrics (``utils/font_metrics.py``), so it is matplotlib's to a pixel or
  two.

Tick labels, axis labels, the title and the legend's text are drawn with
the Hershey glyphs of ``utils/text_atlas.py`` (``raster.put_text``'s
atlas), scaled to the font size.  Pixels are not matplotlib's (Agg's
antialiasing, its fonts); the geometry and the numbers are.  Tick labels
print the values in fixed notation, with no offset or power-of-ten
multiplier.

:meth:`Plot.savefig` writes by the path's extension: ``.png`` through
``utils/png.py``, ``.pdf`` as a vector PDF (paths and base-14 Helvetica
text, no embedded font), a path without one gets ``.png`` as ``savefig``
does, and any other extension raises ``ValueError``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DPI = 100
FIG_SIZE = (640, 480)  # px
# Subplot margins: left, bottom, right, top (figure fractions).
SUBPLOT = (0.125, 0.11, 0.9, 0.88)
PT = DPI / 72.0  # px a point
TAB10 = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf"]
LINE_WIDTH = 1.5  # pt, lines.linewidth
MARKER_SIZE = 6.0  # pt, lines.markersize
FONT_SIZE = 10.0  # pt, font.size (ticks, labels, legend)
TITLE_SIZE = 12.0  # pt, axes.titlesize "large"
TEXT_HEIGHT = {10.0: 14.0, 12.0: 18.0}  # px: matplotlib's text box heights here
# Dash patterns in units of the line width (lines.*_pattern, scaled).
DASHES = {"--": (3.7, 1.6), ":": (1.0, 1.65), "-.": (6.4, 1.6, 1.0, 1.6)}
STEPS = np.array([1.0, 2.0, 2.5, 5.0, 10.0])
LEGEND_CODES = {"upper right": 1, "upper left": 2, "lower left": 3, "lower right": 4,
                "right": 5, "center left": 6, "center right": 7, "lower center": 8,
                "upper center": 9, "center": 10}
_ANCHORS = [None, "NE", "NW", "SW", "SE", "E", "W", "E", "S", "N", "C"]


def _rgb(color: str) -> np.ndarray:
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.float64)


def text_width(text: str, size: float = FONT_SIZE) -> float:
    """Width in px of ``text`` at ``size`` pt as matplotlib measures it: the
    ink box of the glyphs laid at their advances (no kerning)."""
    from dream_tpu_torch.utils.font_metrics import METRICS

    pen, lo, hi = 0, None, None
    for ch in text:
        advance, x0, x1 = METRICS.get(ord(ch), METRICS[ord("?")])
        if x1 > x0:
            lo = pen / 8 + x0 if lo is None else min(lo, pen / 8 + x0)
            hi = pen / 8 + x1 if hi is None else max(hi, pen / 8 + x1)
        pen += advance
    return 0.0 if lo is None else (hi - lo) / 64 * size / FONT_SIZE


# --- matplotlib's locator arithmetic (ticker.py, transforms.py) ---

def nonsingular(vmin: float, vmax: float, expander: float = 0.001,
                tiny: float = 1e-15) -> Tuple[float, float]:
    """``matplotlib.transforms.nonsingular``."""
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        vmin -= expander * abs(vmin)
        vmax += expander * abs(vmax)
    return vmin, vmax


def _scale_range(vmin: float, vmax: float, n: int, threshold: float = 100) -> Tuple[float, float]:
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0 if abs(meanv) / dv < threshold else math.copysign(
        10 ** (math.log10(abs(meanv)) // 1), meanv)
    return 10 ** (math.log10(dv / n) // 1), offset


def _edge_tol(step: float, offset: float) -> float:
    if offset > 0:
        return min(0.4999, max(1e-10, 10 ** (np.log10(offset / step) - 12)))
    return 1e-10


def _edge_le(x: float, step: float, offset: float) -> float:
    d, m = divmod(x, step)
    return d + 1 if abs(m / step - 1) < _edge_tol(step, offset) else d


def _edge_ge(x: float, step: float, offset: float) -> float:
    d, m = divmod(x, step)
    return d if abs(m / step) < _edge_tol(step, offset) else d + 1


def tick_values(vmin: float, vmax: float, nbins: int = 9, min_n_ticks: int = 2) -> np.ndarray:
    """``MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]).tick_values``: the
    ticks spanning ``[vmin, vmax]``, one beyond an end where the step needs
    it."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = np.concatenate([0.1 * STEPS[:-1], STEPS, [10 * STEPS[1]]]) * scale  # _staircase
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = int(np.nonzero(large)[0][0]) if large.any() else len(steps) - 1
    ticks = None
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        low = _edge_le(_vmin - best_vmin, step, abs(offset))
        high = _edge_ge(_vmax - best_vmin, step, abs(offset))
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= min_n_ticks:
            break
    return ticks + offset


def tick_labels(ticks: Sequence[float]) -> List[str]:
    """Fixed-notation labels with the decimals the tick step needs."""
    ticks = list(ticks)
    if len(ticks) < 2:
        return [f"{t:g}" for t in ticks]
    step = abs(ticks[1] - ticks[0])
    for decimals in range(0, 12):
        if abs(round(step, decimals) - step) <= 1e-9 * step:
            break
    labels = [f"{t:.{decimals}f}" for t in ticks]
    return [label.lstrip("-") if float(label) == 0 else label for label in labels]


def _segments_cross_box(xy: np.ndarray, box: Tuple[float, float, float, float]) -> bool:
    """``Path.intersects_bbox(box, filled=False)`` of a polyline: its first
    vertex in the box, or a segment crossing it (matplotlib's
    ``path_intersects_rectangle``)."""
    x0, y0, x1, y1 = box
    cx, cy, w, h = (x0 + x1) / 2, (y0 + y1) / 2, abs(x1 - x0), abs(y1 - y0)
    if len(xy) == 0:
        return False
    if 2 * abs(xy[0, 0] - cx) <= w and 2 * abs(xy[0, 1] - cy) <= h:
        return True
    a, b = xy[:-1], xy[1:]
    hit = ((np.abs(a[:, 0] + b[:, 0] - 2 * cx) < np.abs(a[:, 0] - b[:, 0]) + w)
           & (np.abs(a[:, 1] + b[:, 1] - 2 * cy) < np.abs(a[:, 1] - b[:, 1]) + h)
           & (2 * np.abs((a[:, 0] - cx) * (a[:, 1] - b[:, 1]) - (a[:, 1] - cy) * (a[:, 0] - b[:, 0]))
              < w * np.abs(a[:, 1] - b[:, 1]) + h * np.abs(a[:, 0] - b[:, 0])))
    return bool(hit.any())


def _parse_fmt(fmt: str) -> Tuple[Optional[str], Optional[str]]:
    """A format string's (marker, line style); ``" "`` draws nothing."""
    if fmt.strip() == "":
        return None, None
    marker = "." if "." in fmt.replace("-.", "") else None
    rest = fmt.replace(".", "", 1) if marker else fmt
    for style in ("--", "-.", ":", "-"):
        if style in rest:
            return marker, style
    if marker is None and rest:
        raise ValueError(f"unsupported format {fmt!r}")
    return marker, None


class _Series:
    def __init__(self, kind: str, x, y, color: str, label: Optional[str], marker=None,
                 style=None, linewidth=LINE_WIDTH, alpha=1.0, yerr=None, y2=None):
        self.kind, self.color, self.label = kind, color, label
        self.x = np.asarray(x, np.float64).reshape(-1)
        self.y = np.asarray(y, np.float64).reshape(-1)
        self.marker, self.style, self.linewidth, self.alpha = marker, style, linewidth, alpha
        self.yerr = None if yerr is None else np.asarray(yerr, np.float64).reshape(-1)
        self.y2 = None if y2 is None else np.broadcast_to(np.asarray(y2, np.float64), self.x.shape)

    def data_points(self) -> np.ndarray:
        """Points that bound the data limits."""
        if self.kind == "fill":
            return np.concatenate([np.stack([self.x, self.y], 1), np.stack([self.x, self.y2], 1)])
        pts = [np.stack([self.x, self.y], 1)]
        if self.yerr is not None:
            pts += [np.stack([self.x, self.y - self.yerr], 1), np.stack([self.x, self.y + self.yerr], 1)]
        return np.concatenate(pts) if len(self.x) else np.zeros((0, 2))

    def polygon(self) -> np.ndarray:
        """fill_between's closed polygon (FillBetweenPolyCollection)."""
        pts = np.concatenate([[[self.x[0], self.y2[0]]], np.stack([self.x, self.y], 1),
                              [[self.x[-1], self.y2[-1]]], np.stack([self.x, self.y2], 1)[::-1]])
        return np.concatenate([pts, pts[:1]])


class Plot:
    """One axes on matplotlib's default figure (``fig, ax = plt.subplots()``).

    Add series with :meth:`plot`, :meth:`errorbar` and
    :meth:`fill_between`; :meth:`view_limits`, :meth:`ticks` and
    :meth:`legend_box` give the geometry matplotlib would draw;
    :meth:`render` the image and :meth:`savefig` the file."""

    def __init__(self):
        self.series: List[_Series] = []
        self.xlim: Optional[Tuple[float, float]] = None
        self.ylim: Optional[Tuple[float, float]] = None
        self.title = self.xlabel = self.ylabel = ""
        self.grid_alpha: Optional[float] = None  # None: no grid
        self.legend_loc: Optional[str] = None
        self._line_colors = 0
        self._fill_colors = 0

    # --- building ---

    def _next(self, fill: bool = False) -> str:
        if fill:
            self._fill_colors += 1
            return TAB10[(self._fill_colors - 1) % len(TAB10)]
        self._line_colors += 1
        return TAB10[(self._line_colors - 1) % len(TAB10)]

    def plot(self, x, y, fmt: str = "-", label: Optional[str] = None,
             linewidth: float = LINE_WIDTH, alpha: float = 1.0) -> None:
        """``ax.plot(x, y, fmt, ...)``; a 2-D ``y`` is one line a column."""
        marker, style = _parse_fmt(fmt)
        y = np.asarray(y, np.float64)
        columns = y.T if y.ndim == 2 else [y]
        for column in columns:
            self.series.append(_Series("line", x, column, self._next(), label, marker, style,
                                       linewidth, alpha))

    def errorbar(self, x, y, yerr, marker: str = ".", linestyle: str = "-",
                 label: Optional[str] = None) -> None:
        """``ax.errorbar(x, y, yerr=..., marker, linestyle, label)``: the
        line and a vertical bar at each point, no caps."""
        self.series.append(_Series("line", x, y, self._next(), label, marker or None,
                                   linestyle or None, LINE_WIDTH, 1.0, yerr=yerr))

    def fill_between(self, x, y1, y2=0.0, alpha: float = 1.0,
                     label: Optional[str] = None) -> None:
        """``ax.fill_between(x, y1, y2, alpha=..., label=...)``."""
        self.series.append(_Series("fill", x, y1, self._next(fill=True), label, alpha=alpha,
                                   y2=y2))

    def grid(self, visible: bool = True, alpha: float = 1.0) -> None:
        self.grid_alpha = alpha if visible else None

    def set_xlim(self, lo, hi=None) -> None:
        lo, hi = lo if hi is not None else lo[0], hi if hi is not None else lo[1]
        self.xlim = nonsingular(lo, hi, expander=0.05)

    def set_ylim(self, lo, hi=None) -> None:
        lo, hi = lo if hi is not None else lo[0], hi if hi is not None else lo[1]
        self.ylim = nonsingular(lo, hi, expander=0.05)

    def set_xlabel(self, text: str) -> None:
        self.xlabel = text

    def set_ylabel(self, text: str) -> None:
        self.ylabel = text

    def set_title(self, text: str) -> None:
        self.title = text

    def legend(self, loc: str = "best") -> None:
        if loc != "best" and loc not in LEGEND_CODES:
            raise ValueError(f"unknown legend location {loc!r}")
        self.legend_loc = loc

    # --- geometry (display pixels, origin at the bottom left, y up) ---

    @staticmethod
    def axes_box() -> Tuple[float, float, float, float]:
        """The axes in display px: (x0, y0, x1, y1), y up."""
        w, h = FIG_SIZE
        return SUBPLOT[0] * w, SUBPLOT[1] * h, SUBPLOT[2] * w, SUBPLOT[3] * h

    def _auto(self, axis: int, given) -> Tuple[float, float]:
        if given is not None:
            return given
        pts = [s.data_points()[:, axis] for s in self.series]
        values = np.concatenate(pts) if pts else np.zeros(0)
        values = values[np.isfinite(values)]
        lo, hi = (values.min(), values.max()) if len(values) else (-np.inf, np.inf)
        lo, hi = nonsingular(lo, hi, expander=0.05)
        delta = (hi - lo) * 0.05
        return nonsingular(lo - delta, hi + delta, expander=1e-12, tiny=1e-13)

    def view_limits(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        return self._auto(0, self.xlim), self._auto(1, self.ylim)

    def _nbins(self, axis: int) -> int:
        x0, y0, x1, y1 = self.axes_box()
        length = ((x1 - x0) if axis == 0 else (y1 - y0)) / DPI * 72
        size = FONT_SIZE * (3 if axis == 0 else 2)
        return int(np.clip(int(np.floor(length / size)), 1, 9))

    def ticks(self) -> Tuple[np.ndarray, np.ndarray]:
        """The visible major ticks of each axis."""
        out = []
        for axis, (lo, hi) in enumerate(self.view_limits()):
            t = tick_values(lo, hi, self._nbins(axis))
            tol = 1e-10 * abs(hi - lo)
            out.append(t[(t >= min(lo, hi) - tol) & (t <= max(lo, hi) + tol)])
        return out[0], out[1]

    def to_display(self, x, y) -> np.ndarray:
        (xl0, xl1), (yl0, yl1) = self.view_limits()
        ax0, ay0, ax1, ay1 = self.axes_box()
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return np.stack([ax0 + (x - xl0) / (xl1 - xl0) * (ax1 - ax0),
                         ay0 + (y - yl0) / (yl1 - yl0) * (ay1 - ay0)], -1)

    def _legend_entries(self) -> List[_Series]:
        return [s for s in self.series if s.label and not s.label.startswith("_")]

    def legend_size(self) -> Tuple[float, float]:
        fs = FONT_SIZE * PT
        entries = self._legend_entries()
        width = max(text_width(s.label) for s in entries) + 2 * 0.4 * fs + 2.0 * fs + 0.8 * fs
        height = len(entries) * TEXT_HEIGHT[FONT_SIZE] + (len(entries) - 1) * 0.5 * fs + 2 * 0.4 * fs
        return width, height

    def _anchored(self, code: int, width: float, height: float) -> Tuple[float, float]:
        pad = 0.5 * FONT_SIZE * PT
        x0, y0, x1, y1 = self.axes_box()
        x0, y0, x1, y1 = x0 + pad, y0 + pad, x1 - pad, y1 - pad
        c = _ANCHORS[code]
        left = x0 if "W" in c else x1 - width if "E" in c else (x0 + x1 - width) / 2
        bottom = y0 if "S" in c else y1 - height if "N" in c else (y0 + y1 - height) / 2
        return left, bottom

    def legend_box(self) -> Optional[Tuple[str, Tuple[float, float, float, float]]]:
        """(location, (x0, y0, x1, y1) in display px) of the legend, or None."""
        if self.legend_loc is None or not self._legend_entries():
            return None
        width, height = self.legend_size()
        if self.legend_loc != "best":
            code = LEGEND_CODES[self.legend_loc]
        else:
            paths = []
            for s in self.series:
                xy = s.polygon() if s.kind == "fill" else np.stack([s.x, s.y], 1)
                if len(xy):
                    paths.append(self.to_display(xy[:, 0], xy[:, 1]))
            candidates = []
            for code in range(1, 11):
                l, b = self._anchored(code, width, height)
                box = (l, b, l + width, b + height)
                badness = 0
                for xy in paths:
                    badness += int(((xy[:, 0] > box[0]) & (xy[:, 0] < box[2])
                                    & (xy[:, 1] > box[1]) & (xy[:, 1] < box[3])).sum())
                    badness += int(_segments_cross_box(xy, box))
                candidates.append((badness, code))
                if badness == 0:
                    break
            code = min(candidates)[1]
        l, b = self._anchored(code, width, height)
        name = next(k for k, v in LEGEND_CODES.items() if v == code)
        return name, (l, b, l + width, b + height)

    # --- output ---

    def _scene(self) -> List[tuple]:
        """Everything to draw, in draw order, in display px (y up):
        ("poly", pts, rgb, alpha), ("path", pts, rgb, alpha, width_px,
        dashes_px or None), ("dots", pts, rgb, alpha, radius_px), ("rect",
        box, fill_rgb, fill_alpha, edge_rgb, width_px), ("text", text, x, y,
        size_pt, ha, va, rotation)."""
        scene: List[tuple] = []
        (xl0, xl1), (yl0, yl1) = self.view_limits()
        ax0, ay0, ax1, ay1 = self.axes_box()
        xt, yt = self.ticks()
        for s in self.series:
            if s.kind == "fill" and len(s.x):
                poly = s.polygon()
                scene.append(("poly", self.to_display(poly[:, 0], poly[:, 1]), _rgb(s.color), s.alpha, s.label))
        if self.grid_alpha is not None:
            grey = _rgb("#b0b0b0")
            for t in xt:
                scene.append(("path", self.to_display([t, t], [yl0, yl1]), grey, self.grid_alpha,
                              0.8 * PT, None, None))
            for t in yt:
                scene.append(("path", self.to_display([xl0, xl1], [t, t]), grey, self.grid_alpha,
                              0.8 * PT, None, None))
        for s in self.series:
            if s.kind != "line" or not len(s.x):
                continue
            rgb = _rgb(s.color)
            width = s.linewidth * PT
            if s.yerr is not None:
                for x, y, e in zip(s.x, s.y, s.yerr):
                    scene.append(("path", self.to_display([x, x], [y - e, y + e]), rgb, s.alpha,
                                  width, None, None))
            if s.style is not None:
                dashes = ([d * s.linewidth * PT for d in DASHES[s.style]]
                          if s.style in DASHES else None)
                scene.append(("path", self.to_display(s.x, s.y), rgb, s.alpha, width, dashes, s.label))
            if s.marker:
                scene.append(("dots", self.to_display(s.x, s.y), rgb, s.alpha,
                              (0.5 * MARKER_SIZE + 1.0) * PT / 2))
        black = np.zeros(3)
        scene.append(("rect", (ax0, ay0, ax1, ay1), None, 0.0, black, 0.8 * PT))
        tick_len, pad = 3.5 * PT, 3.5 * PT
        for t, label in zip(xt, tick_labels(xt)):
            x = self.to_display(t, yl0)[0]
            scene.append(("path", np.array([[x, ay0], [x, ay0 - tick_len]]), black, 1.0, 0.8 * PT, None, None))
            scene.append(("text", label, x, ay0 - tick_len - pad, FONT_SIZE, "center", "top", 0))
        label_w = 0.0
        for t, label in zip(yt, tick_labels(yt)):
            y = self.to_display(xl0, t)[1]
            scene.append(("path", np.array([[ax0, y], [ax0 - tick_len, y]]), black, 1.0, 0.8 * PT, None, None))
            scene.append(("text", label, ax0 - tick_len - pad, y, FONT_SIZE, "right", "center", 0))
            label_w = max(label_w, text_width(label))
        if self.xlabel:
            y = ay0 - tick_len - pad - TEXT_HEIGHT[FONT_SIZE] - 4.0 * PT
            scene.append(("text", self.xlabel, (ax0 + ax1) / 2, y, FONT_SIZE, "center", "top", 0))
        if self.ylabel:
            x = ax0 - tick_len - pad - label_w - 4.0 * PT
            scene.append(("text", self.ylabel, x, (ay0 + ay1) / 2, FONT_SIZE, "center", "bottom", 90))
        if self.title:
            scene.append(("text", self.title, (ax0 + ax1) / 2, ay1 + 6.0 * PT, TITLE_SIZE,
                          "center", "bottom", 0))
        legend = self.legend_box()
        if legend is not None:
            fs = FONT_SIZE * PT
            _, (l, b, r, t) = legend
            scene.append(("rect", (l, b, r, t), np.full(3, 255.0), 0.8, _rgb("#cccccc"), 1.0 * PT))
            y = t - 0.4 * fs - TEXT_HEIGHT[FONT_SIZE] / 2
            for s in self._legend_entries():
                hx0, hx1 = l + 0.4 * fs, l + 0.4 * fs + 2.0 * fs
                rgb = _rgb(s.color)
                if s.kind == "fill":
                    h = 0.7 * fs
                    scene.append(("poly", np.array([[hx0, y - h / 2], [hx1, y - h / 2], [hx1, y + h / 2],
                                                    [hx0, y + h / 2], [hx0, y - h / 2]]), rgb, s.alpha, None))
                else:
                    if s.style is not None:
                        dashes = ([d * s.linewidth * PT for d in DASHES[s.style]]
                                  if s.style in DASHES else None)
                        scene.append(("path", np.array([[hx0, y], [hx1, y]]), rgb, s.alpha,
                                      s.linewidth * PT, dashes, None))
                    if s.yerr is not None:
                        scene.append(("path", np.array([[(hx0 + hx1) / 2, y - 0.35 * fs],
                                                        [(hx0 + hx1) / 2, y + 0.35 * fs]]), rgb,
                                      s.alpha, s.linewidth * PT, None, None))
                    if s.marker:
                        scene.append(("dots", np.array([[(hx0 + hx1) / 2, y]]), rgb, s.alpha,
                                      (0.5 * MARKER_SIZE + 1.0) * PT / 2))
                scene.append(("text", s.label, hx1 + 0.8 * fs, y, FONT_SIZE, "left", "center", 0))
                y -= TEXT_HEIGHT[FONT_SIZE] + 0.5 * fs
        return scene

    def render(self) -> np.ndarray:
        """The figure as uint8 RGB ``[480, 640, 3]``."""
        canvas = _Canvas(*FIG_SIZE)
        for item in self._scene():
            canvas.draw(item)
        return canvas.image()

    def savefig(self, path: str) -> str:
        """Write the figure; the format follows the extension (``.png``,
        ``.pdf``; none gets ``.png``).  Returns the path written."""
        ext = os.path.splitext(path)[1].lower()
        if ext == "":
            path, ext = path + ".png", ".png"
        if ext == ".png":
            from dream_tpu_torch.utils.png import write_png

            write_png(path, self.render())
        elif ext == ".pdf":
            with open(path, "wb") as f:
                f.write(_pdf(self._scene()))
        else:
            raise ValueError(f"unsupported figure format {ext!r} ({path}): .png or .pdf")
        return path


# --- raster output ---

def _decimate(xy: np.ndarray) -> np.ndarray:
    """Drop interior points of runs that fall in one pixel (a 10,000-point
    curve crosses a few hundred pixels); the ends of each run stay."""
    if len(xy) <= 2:
        return xy
    cell = np.floor(xy).astype(np.int64)
    change = np.any(cell[1:] != cell[:-1], axis=1)
    keep = np.zeros(len(xy), bool)
    keep[0] = keep[-1] = True
    keep[1:][change] = True
    keep[:-1][change] = True
    return xy[keep]


def _dash_segments(xy: np.ndarray, dashes: Optional[Sequence[float]]) -> List[np.ndarray]:
    """The polyline cut into its drawn pieces (all of it without dashes)."""
    if not dashes or len(xy) < 2:
        return [xy]
    pieces, current = [], [xy[0]]
    pattern, i, left, on = list(dashes), 0, dashes[0], True
    for a, b in zip(xy[:-1], xy[1:]):
        seg = float(np.hypot(*(b - a)))
        pos = 0.0
        while seg - pos > left:
            pos += left
            p = a + (b - a) * (pos / seg)
            if on:
                current.append(p)
                pieces.append(np.array(current))
            else:
                current = [p]
            on = not on
            i = (i + 1) % len(pattern)
            left = pattern[i]
        left -= seg - pos
        if on:
            current.append(b)
    if on and len(current) > 1:
        pieces.append(np.array(current))
    return pieces


class _Canvas:
    """A white RGB canvas (float64) in display px, y up; antialiased by
    coverage from the distance to each shape's edge."""

    def __init__(self, width: int, height: int):
        self.w, self.h = width, height
        self.rgb = np.full((height, width, 3), 255.0)

    def image(self) -> np.ndarray:
        return np.clip(np.floor(self.rgb + 0.5), 0, 255).astype(np.uint8)

    def _blend(self, cover: np.ndarray, rgb: np.ndarray, alpha: float, x0: int, y0: int) -> None:
        """Composite ``rgb`` at ``alpha * cover`` over rows/cols starting at
        image row ``y0``, column ``x0``."""
        if cover.size == 0:
            return
        a = (alpha * cover)[..., None]
        region = self.rgb[y0:y0 + cover.shape[0], x0:x0 + cover.shape[1]]
        region *= 1.0 - a
        region += a * rgb

    def _window(self, pts: np.ndarray, margin: float):
        """Image rows/cols bounding display points ``pts`` (y up) plus a
        margin, clipped to the canvas: (x0, x1, y0, y1) or None."""
        xs, ys = pts[:, 0], self.h - pts[:, 1]
        x0 = max(int(np.floor(xs.min() - margin)), 0)
        x1 = min(int(np.ceil(xs.max() + margin)) + 1, self.w)
        y0 = max(int(np.floor(ys.min() - margin)), 0)
        y1 = min(int(np.ceil(ys.max() + margin)) + 1, self.h)
        return None if x0 >= x1 or y0 >= y1 else (x0, x1, y0, y1)

    def _stroke_cover(self, pieces: List[np.ndarray], width: float):
        pts = np.concatenate(pieces)
        win = self._window(pts, width)
        if win is None:
            return None, win
        x0, x1, y0, y1 = win
        cover = np.zeros((y1 - y0, x1 - x0))
        half = width / 2
        for piece in pieces:
            piece = _decimate(piece)
            for a, b in zip(piece[:-1], piece[1:]):
                ax, ay, bx, by = a[0], self.h - a[1], b[0], self.h - b[1]
                sx0 = max(int(np.floor(min(ax, bx) - half - 1)), x0)
                sx1 = min(int(np.ceil(max(ax, bx) + half + 1)) + 1, x1)
                sy0 = max(int(np.floor(min(ay, by) - half - 1)), y0)
                sy1 = min(int(np.ceil(max(ay, by) + half + 1)) + 1, y1)
                if sx0 >= sx1 or sy0 >= sy1:
                    continue
                px = np.arange(sx0, sx1) + 0.5
                py = (np.arange(sy0, sy1) + 0.5)[:, None]
                dx, dy = bx - ax, by - ay
                length2 = dx * dx + dy * dy
                t = np.zeros((1, 1)) if length2 == 0 else np.clip(
                    ((px - ax) * dx + (py - ay) * dy) / length2, 0.0, 1.0)
                dist = np.hypot(px - (ax + t * dx), py - (ay + t * dy))
                c = np.clip(half + 0.5 - dist, 0.0, 1.0)
                window = cover[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0]
                np.maximum(window, c, out=window)
        return cover, win

    def draw(self, item: tuple) -> None:
        kind = item[0]
        if kind == "path":
            _, pts, rgb, alpha, width, dashes = item[:6]
            cover, win = self._stroke_cover(_dash_segments(pts, dashes), width)
            if cover is not None:
                self._blend(cover, rgb, alpha, win[0], win[2])
        elif kind == "dots":
            _, pts, rgb, alpha, radius = item
            win = self._window(pts, radius + 1)
            if win is None:
                return
            x0, x1, y0, y1 = win
            cover = np.zeros((y1 - y0, x1 - x0))
            for x, y in pts:
                y = self.h - y
                sx0, sx1 = max(int(x - radius - 1), x0), min(int(x + radius + 2), x1)
                sy0, sy1 = max(int(y - radius - 1), y0), min(int(y + radius + 2), y1)
                if sx0 >= sx1 or sy0 >= sy1:
                    continue
                dist = np.hypot(np.arange(sx0, sx1) + 0.5 - x, (np.arange(sy0, sy1) + 0.5)[:, None] - y)
                window = cover[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0]
                np.maximum(window, np.clip(radius + 0.5 - dist, 0.0, 1.0), out=window)
            self._blend(cover, rgb, alpha, x0, y0)
        elif kind == "poly":
            _, pts, rgb, alpha = item[:4]
            win = self._window(pts, 1)
            if win is None:
                return
            x0, x1, y0, y1 = win
            xs, ys = pts[:, 0], self.h - pts[:, 1]
            px = np.arange(x0, x1) + 0.5
            py = np.arange(y0, y1) + 0.5
            inside = np.zeros((len(py), len(px)), bool)
            for (ax, ay), (bx, by) in zip(zip(xs[:-1], ys[:-1]), zip(xs[1:], ys[1:])):
                if ay == by:
                    continue
                crosses = ((ay <= py) & (py < by)) | ((by <= py) & (py < ay))
                xc = ax + (py - ay) * (bx - ax) / (by - ay)
                inside ^= crosses[:, None] & (px[None, :] < xc[:, None])
            self._blend(inside.astype(np.float64), rgb, alpha, x0, y0)
        elif kind == "rect":
            _, (l, b, r, t), fill, fill_alpha, edge, width = item
            if fill is not None:
                xa, xb = int(round(l)), int(round(r))
                ya, yb = int(round(self.h - t)), int(round(self.h - b))
                self._blend(np.ones((yb - ya, xb - xa)), fill, fill_alpha, xa, ya)
            box = np.array([[l, b], [r, b], [r, t], [l, t], [l, b]])
            cover, win = self._stroke_cover([box], width)
            if cover is not None:
                self._blend(cover, edge, 1.0, win[0], win[2])
        elif kind == "text":
            _, text, x, y, size, ha, va, rotation = item
            mask = _text_mask(text, size)
            if rotation:
                mask = np.rot90(mask)
            h, w = mask.shape
            if rotation:
                left = x - w if va == "bottom" else x - w / 2
                top = self.h - y - (h / 2 if ha == "center" else 0)
            else:
                left = x - (w / 2 if ha == "center" else w if ha == "right" else 0)
                top = self.h - y - (0 if va == "top" else h / 2 if va == "center" else h)
            xa, ya = int(round(left)), int(round(top))
            xb, yb = min(xa + w, self.w), min(ya + h, self.h)
            mx, my = max(-xa, 0), max(-ya, 0)
            xa, ya = max(xa, 0), max(ya, 0)
            if xa < xb and ya < yb:
                self._blend(mask[my:my + yb - ya, mx:mx + xb - xa], np.zeros(3), 1.0, xa, ya)


def _text_mask(text: str, size: float) -> np.ndarray:
    """Coverage (0-1, ``[h, w]``) of ``text`` in the atlas's Hershey glyphs,
    scaled so that a digit is as tall as DejaVu Sans's at ``size`` pt."""
    from dream_tpu_torch.utils import text_atlas

    glyphs = text_atlas.glyphs()
    placed, x = [], 0
    for ch in text:
        alpha, ox, oy, advance = glyphs[ch if " " <= ch <= "~" else "?"]
        if alpha.size:
            placed.append((alpha, x + ox, oy))
        x += advance
    if not placed:
        return np.zeros((1, 1))
    top = min(oy for _, _, oy in placed)
    bottom = max(oy + a.shape[0] for a, _, oy in placed)
    left = min(px for _, px, _ in placed)
    right = max(px + a.shape[1] for a, px, _ in placed)
    full = np.zeros((bottom - top, right - left))
    for alpha, px, oy in placed:
        window = full[oy - top:oy - top + alpha.shape[0], px - left:px - left + alpha.shape[1]]
        np.maximum(window, alpha / 255.0, out=window)
    # A Hershey digit at the atlas's scale is 17 px tall; DejaVu Sans's is
    # 0.73 em.
    scale = 0.73 * size * PT / 17.0
    h, w = max(1, int(round(full.shape[0] * scale))), max(1, int(round(full.shape[1] * scale)))
    return _area_resize(full, h, w)


def _area_resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Box-filter resize of a 2-D array (each output pixel the mean of the
    input area it covers)."""
    def weights(n_in, n_out):
        edges = np.linspace(0, n_in, n_out + 1)
        m = np.zeros((n_out, n_in))
        for i in range(n_out):
            lo, hi = edges[i], edges[i + 1]
            for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
                m[i, j] = min(hi, j + 1) - max(lo, j)
        return m / m.sum(1, keepdims=True)

    return weights(a.shape[0], h) @ a @ weights(a.shape[1], w).T


# --- PDF output ---

def _pdf_escape(text: str) -> str:
    text = "".join(ch if " " <= ch <= "~" else "?" for ch in text)
    return text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _pdf(scene: List[tuple]) -> bytes:
    """A one-page PDF of the scene: vector paths, and text in the base-14
    Helvetica (no embedded font).  Each series' path is preceded by a
    ``% series`` comment naming it."""
    k = 72.0 / DPI  # pt a px
    width, height = FIG_SIZE[0] * k, FIG_SIZE[1] * k
    alphas: Dict[float, str] = {}
    ops = ["1 1 1 rg", f"0 0 {width:.3f} {height:.3f} re f"]

    def gs(alpha):
        name = alphas.setdefault(round(alpha, 4), f"/A{len(alphas)}")
        return f"{name} gs"

    def color(rgb, op):
        return " ".join(f"{c / 255:.4f}" for c in rgb) + f" {op}"

    def path(pts):
        out = [f"{pts[0][0] * k:.3f} {pts[0][1] * k:.3f} m"]
        out += [f"{x * k:.3f} {y * k:.3f} l" for x, y in pts[1:]]
        return " ".join(out)

    for item in scene:
        kind = item[0]
        if kind == "path":
            _, pts, rgb, alpha, w, dashes, label = item
            if label is not None:
                ops.append(f"% series {_pdf_escape(label)}")
            dash = "[" + " ".join(f"{d * k:.3f}" for d in dashes) + "] 0 d" if dashes else "[] 0 d"
            ops += ["q", gs(alpha), color(rgb, "RG"), f"{w * k:.3f} w", "1 J 1 j", dash,
                    path(_decimate(pts)) + " S", "Q"]
        elif kind == "poly":
            _, pts, rgb, alpha, label = item
            if label is not None:
                ops.append(f"% series {_pdf_escape(label)}")
            ops += ["q", gs(alpha), color(rgb, "rg"), path(pts) + " h f", "Q"]
        elif kind == "dots":
            _, pts, rgb, alpha, r = item
            c = 0.5523 * r
            ops += ["q", gs(alpha), color(rgb, "rg")]
            for x, y in pts:
                x, y, rr, cc = x * k, y * k, r * k, c * k
                ops.append(f"{x + rr:.3f} {y:.3f} m {x + rr:.3f} {y + cc:.3f} {x + cc:.3f} {y + rr:.3f} "
                           f"{x:.3f} {y + rr:.3f} c {x - cc:.3f} {y + rr:.3f} {x - rr:.3f} {y + cc:.3f} "
                           f"{x - rr:.3f} {y:.3f} c {x - rr:.3f} {y - cc:.3f} {x - cc:.3f} {y - rr:.3f} "
                           f"{x:.3f} {y - rr:.3f} c {x + cc:.3f} {y - rr:.3f} {x + rr:.3f} {y - cc:.3f} "
                           f"{x + rr:.3f} {y:.3f} c f")
            ops.append("Q")
        elif kind == "rect":
            _, (l, b, r, t), fill, fill_alpha, edge, w = item
            rect = f"{l * k:.3f} {b * k:.3f} {(r - l) * k:.3f} {(t - b) * k:.3f} re"
            if fill is not None:
                ops += ["q", gs(fill_alpha), color(fill, "rg"), rect + " f", "Q"]
            ops += ["q", color(edge, "RG"), f"{w * k:.3f} w", rect + " S", "Q"]
        elif kind == "text":
            _, text, x, y, size, ha, va, rotation = item
            along = -(text_width(text, size) * k) * (0.5 if ha == "center" else 1.0 if ha == "right" else 0.0)
            # The baseline below the anchor: ascent 0.76 em, descent 0.21 em.
            rise = {"top": -0.76, "center": -0.3, "bottom": 0.21}[va] * size
            if rotation:
                # A quarter turn: the text runs up, its bottom facing +x.
                matrix = f"0 1 -1 0 {x * k - rise:.3f} {y * k + along:.3f} Tm"
            else:
                matrix = f"1 0 0 1 {x * k + along:.3f} {y * k + rise:.3f} Tm"
            ops += ["BT", "0 0 0 rg", f"/F1 {size:.1f} Tf", matrix, f"({_pdf_escape(text)}) Tj", "ET"]
    content = "\n".join(ops).encode("latin-1")
    states = " ".join(f"{name} << /CA {a} /ca {a} >>" for a, name in alphas.items())
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {width:.1f} {height:.1f}] "
         f"/Resources << /Font << /F1 5 0 R >> /ExtGState << {states} >> >> "
         "/Contents 4 0 R >>").encode("latin-1"),
        b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /Encoding /WinAnsiEncoding >>",
    ]
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (len(objects) + 1, xref)
    return bytes(out)
