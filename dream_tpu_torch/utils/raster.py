"""OpenCV's raster primitives on uint8 numpy images, pixel for pixel.

``dream_tpu/visualize.py`` draws with ``cv2.circle`` (subpixel centres,
``shift=4``), ``cv2.line`` (thickness 3) and ``cv2.putText``
(``FONT_HERSHEY_SIMPLEX``, scale 0.75, thickness 2).  The port runs where
OpenCV is not installed, so this module carries the integer algorithms of
OpenCV's ``imgproc/src/drawing.cpp`` for 8-connected lines (``LINE_8``):

- :func:`circle`: with ``shift > 0`` (or a thickness above 1) OpenCV goes
  through ``EllipseEx``: ``ellipse2Poly`` samples the circle every
  ``delta`` degrees from its ``SinTable`` (``delta`` 90 below a 3 px
  radius, 30 below 10 px, 18 below 15 px, else 5), each vertex is rounded to
  16-bit fixed point (``XY_SHIFT = 16``), and the polygon is filled by
  ``FillConvexPoly`` (an 8-connected outline by ``Line2``, then scanlines)
  or stroked by ``PolyLine``.  Otherwise the integer midpoint ``Circle``.
- :func:`line`: ``ThickLine``: thickness 1 is Bresenham (``LineIterator``,
  8-connected, clipped to the image) between the ends rounded to whole
  pixels, with or without ``shift``, as OpenCV 5 draws it; a thicker line
  first has its ends clipped to the image grown by the thickness on every
  side (OpenCV 5 again), then fills the quadrilateral offset by the
  rounded fixed-point normal (half a pixel more for odd thickness) and
  draws round caps with the integer ``Circle``.
- :func:`put_text`: OpenCV 5 renders Hershey text antialiased, glyph by
  glyph at whole-pixel advances; a string's coverage is the maximum of its
  glyphs' coverages, blended over the image as
  ``round(bg * (1 - a) + color * a)``.  The coverage of each of the 95
  printable ASCII glyphs at the one size ``dream_tpu`` uses is in
  :mod:`dream_tpu_torch.utils.text_atlas`.

Coordinates off the image are clipped as OpenCV clips them; C's integer
division (toward zero) and ``cvRound`` (half to even) are kept.  Where
OpenCV 5 departs from OpenCV 4's ``drawing.cpp`` (thin lines, the thick
line's clip, text), the departure was found and is held against the
``cv2`` 5.0.0 of the test machine (``tests/test_torch_visualize.py``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's SinTable: sin of 0..450 degrees, written in its source as
# 7-decimal float literals.
_SIN_TABLE = np.float32(np.round(np.sin(np.radians(np.arange(451))), 7)).astype(np.float64)


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(img: np.ndarray, color) -> np.ndarray:
    channels = 1 if img.ndim == 2 else img.shape[2]
    values = list(color) if isinstance(color, (tuple, list, np.ndarray)) else [color]
    values = (values + [0] * channels)[:channels]
    return np.asarray([int(v) for v in values], dtype=np.uint8)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color: np.ndarray) -> None:
    """``ICV_HLINE``: pixels ``x1..x2`` of row ``y``, both included."""
    if x1 <= x2:
        img[y, x1 : x2 + 1] = color


def _clip_line(width: int, height: int, p1: List[int], p2: List[int]) -> bool:
    """``clipLine`` on a ``width x height`` box (pixels, or fixed point for
    ``Line2``); moves the end points onto the box and returns whether any
    part of the line is inside."""
    if width <= 0 or height <= 0:
        return False
    right, bottom = width - 1, height - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _put_points(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color: np.ndarray) -> None:
    inside = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[inside], xs[inside]] = color


def _line_bresenham(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
                    color: np.ndarray) -> None:
    """``Line`` with an 8-connected ``LineIterator`` (left to right)."""
    a, b = [int(p0[0]), int(p0[1])], [int(p1[0]), int(p1[1])]
    if not _clip_line(img.shape[1], img.shape[0], a, b):
        return
    if b[0] < a[0]:
        a, b = b, a
    dx, dy = b[0] - a[0], b[1] - a[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = a
    xs, ys = [], []
    for _ in range(dx + 1):
        xs.append(x)
        ys.append(y)
        mask = err < 0
        err += -(dy + dy) + (dx + dx if mask else 0)
        # The minus step always moves along the major axis, the plus step
        # (taken when err went negative) along the minor one.
        if steep:
            y += sy
            if mask:
                x += 1
        else:
            x += 1
            if mask:
                y += sy
    _put_points(img, np.asarray(xs), np.asarray(ys), color)


def _line2(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color: np.ndarray) -> None:
    """``Line2``: an 8-connected line between fixed-point (16-bit) ends."""
    a, b = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not _clip_line(img.shape[1] << XY_SHIFT, img.shape[0] << XY_SHIFT, a, b):
        return
    dx, dy = b[0] - a[0], b[1] - a[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            a, b = b, a
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        ecount = (b[0] - a[0]) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            a, b = b, a
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (b[1] - a[1]) >> XY_SHIFT
    half = XY_ONE >> 1
    x1, y1 = a[0] + half, a[1] + half
    _put_points(img, np.asarray([(b[0] + half) >> XY_SHIFT]),
                np.asarray([(b[1] + half) >> XY_SHIFT]), color)
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + k
        ys = (y1 + k * y_step) >> XY_SHIFT
    else:
        xs = (x1 + k * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + k
    _put_points(img, xs, ys, color)


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color: np.ndarray,
                      shift: int) -> None:
    """``FillConvexPoly`` for ``LINE_8``: the outline by ``Line2`` (or
    ``Line`` at ``shift == 0``), then the scanlines between the two edge
    chains that leave the top vertex."""
    npts = len(v)
    height, width = img.shape[:2]
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if shift == 0:
            _line_bresenham(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                            (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= width or ymin >= height:
        return
    ymax = min(ymax, height - 1)
    edge_idx = [imin, imin]
    edge_di = [1, npts - 1]
    edge_x = [-XY_ONE, -XY_ONE]
    edge_dx = [0, 0]
    edge_ye = [ymin, ymin]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= edge_ye[i]:
                idx0, di = edge_idx[i], edge_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        edge_ye[i] = ty
                        edge_dx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        edge_x[i] = xs
                        edge_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge_x[0] > edge_x[1] else (0, 1)
            xx1 = (edge_x[left] + delta1) >> XY_SHIFT
            xx2 = (edge_x[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < width:
                _hline(img, y, max(xx1, 0), min(xx2, width - 1), color)
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1
        if y > ymax:
            break


def _circle_int(img: np.ndarray, center: Tuple[int, int], radius: int, color: np.ndarray,
                fill: bool) -> None:
    """The integer midpoint ``Circle`` (thin, or filled by spans)."""
    height, width = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if not 0 <= yy < height:
                continue
            if fill:
                if xa < width and xb >= 0:
                    _hline(img, yy, max(xa, 0), min(xb, width - 1), color)
            else:
                for xx in (xa, xb):
                    if 0 <= xx < width:
                        img[yy, xx] = color
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color: np.ndarray,
                thickness: int, flags: int, shift: int) -> None:
    """``ThickLine`` for ``LINE_8``; ``flags`` bit 0 and 1 cap the first and
    the second end."""
    up = XY_SHIFT - shift
    p0 = (p0[0] << up, p0[1] << up)
    p1 = (p1[0] << up, p1[1] << up)
    half = XY_ONE >> 1
    if thickness <= 1:
        _line_bresenham(img, ((p0[0] + half) >> XY_SHIFT, (p0[1] + half) >> XY_SHIFT),
                        ((p1[0] + half) >> XY_SHIFT, (p1[1] + half) >> XY_SHIFT), color)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        quad = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _circle_int(img, ((p[0] + half) >> XY_SHIFT, (p[1] + half) >> XY_SHIFT),
                        (thickness + half) >> XY_SHIFT, color, True)


def _poly_line(img: np.ndarray, v: Sequence[Tuple[int, int]], color: np.ndarray, thickness: int,
               shift: int) -> None:
    """``PolyLine``, open: the first segment caps both ends, the others
    their second end."""
    flags = 3
    for p0, p1 in zip(v[:-1], v[1:]):
        _thick_line(img, p0, p1, color, thickness, flags, shift)
        flags = 2


def _ellipse_to_poly(center: Tuple[float, float], axes: Tuple[float, float], delta: int
                     ) -> List[Tuple[float, float]]:
    """``ellipse2Poly`` (double version) for a full, unrotated ellipse:
    vertices every ``delta`` degrees from ``SinTable`` (its rotation's
    cosine 1 and sine 0 change no bit)."""
    pts = []
    for i in range(0, 360 + delta, delta):
        angle = min(i, 360)
        pts.append((center[0] + axes[0] * _SIN_TABLE[450 - angle],
                    center[1] + axes[1] * _SIN_TABLE[angle]))
    return pts


def _ellipse_ex(img: np.ndarray, center: Tuple[int, int], axes: Tuple[int, int],
                color: np.ndarray, thickness: int) -> None:
    """``EllipseEx`` for a full circle or ellipse, in 16-bit fixed point."""
    axes = (abs(axes[0]), abs(axes[1]))
    delta = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v: List[Tuple[int, int]] = []
    for fx, fy in _ellipse_to_poly((float(center[0]), float(center[1])),
                                  (float(axes[0]), float(axes[1])), delta):
        px = round(fx / XY_ONE) << XY_SHIFT
        py = round(fy / XY_ONE) << XY_SHIFT
        pt = (px + round(fx - px), py + round(fy - py))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center), tuple(center)]
    if thickness >= 0:
        _poly_line(img, v, color, thickness, XY_SHIFT)
    else:
        _fill_convex_poly(img, v, color, XY_SHIFT)


def _check_image(img: np.ndarray) -> None:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim in (2, 3)):
        raise TypeError("raster functions draw on uint8 [H, W] or [H, W, C] numpy arrays")


def circle(img: np.ndarray, center: Tuple[int, int], radius: int, color, thickness: int = 1,
           shift: int = 0) -> np.ndarray:
    """``cv2.circle`` (``LINE_8``), in place on ``img``, which is returned.

    ``center`` and ``radius`` are integers with ``shift`` fractional bits;
    ``thickness < 0`` fills."""
    _check_image(img)
    if radius < 0 or not 0 <= shift <= XY_SHIFT:
        raise ValueError("circle: radius must be >= 0 and shift in [0, 16]")
    c = _color(img, color)
    if thickness > 1 or shift > 0:
        up = XY_SHIFT - shift
        r = int(radius) << up
        _ellipse_ex(img, (int(center[0]) << up, int(center[1]) << up), (r, r), c, thickness)
    else:
        _circle_int(img, (int(center[0]), int(center[1])), int(radius), c, thickness < 0)
    return img


def line(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color,
         thickness: int = 1) -> np.ndarray:
    """``cv2.line`` (``LINE_8``, ``shift=0``), in place on ``img``, which is
    returned; both ends get round caps."""
    _check_image(img)
    thickness = int(thickness)
    if thickness <= 0:
        raise ValueError("line: thickness must be positive")
    # OpenCV 5 first clips a thick line's ends to the image grown by the
    # thickness on every side, in whole pixels.
    m = thickness if thickness > 1 else 0
    a = [int(pt1[0]) + m, int(pt1[1]) + m]
    b = [int(pt2[0]) + m, int(pt2[1]) + m]
    if _clip_line(img.shape[1] + 2 * m, img.shape[0] + 2 * m, a, b):
        _thick_line(img, (a[0] - m, a[1] - m), (b[0] - m, b[1] - m), _color(img, color),
                    thickness, 3, 0)
    return img


def _glyph_key(ch: str) -> str:
    return ch if " " <= ch <= "~" else "?"


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], color) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.75, color, 2)``
    (the one size ``dream_tpu`` draws) as OpenCV 5 draws it: antialiased
    glyph coverage from the committed atlas, composited at whole-pixel
    advances by maximum and blended over ``img`` (in place; returned).
    Characters outside printable ASCII are drawn as ``?``."""
    from dream_tpu_torch.utils import text_atlas

    _check_image(img)
    glyphs = text_atlas.glyphs()
    height, width = img.shape[:2]
    x, y = int(org[0]), int(org[1])
    placed = []
    for ch in text:
        alpha, ox, oy, advance = glyphs[_glyph_key(ch)]
        if alpha.size:
            placed.append((alpha, x + ox, y + oy))
        x += advance
    if not placed:
        return img
    x0 = max(min(px for _, px, _ in placed), 0)
    y0 = max(min(py for _, _, py in placed), 0)
    x1 = min(max(px + a.shape[1] for a, px, _ in placed), width)
    y1 = min(max(py + a.shape[0] for a, _, py in placed), height)
    if x0 >= x1 or y0 >= y1:
        return img
    cover = np.zeros((y1 - y0, x1 - x0), np.uint8)
    for alpha, px, py in placed:
        gx0, gy0 = max(px, x0), max(py, y0)
        gx1, gy1 = min(px + alpha.shape[1], x1), min(py + alpha.shape[0], y1)
        if gx0 < gx1 and gy0 < gy1:
            window = cover[gy0 - y0 : gy1 - y0, gx0 - x0 : gx1 - x0]
            np.maximum(window, alpha[gy0 - py : gy1 - py, gx0 - px : gx1 - px], out=window)
    a = cover.astype(np.float64) / 255.0
    region = img[y0:y1, x0:x1]
    c = _color(img, color).astype(np.float64)
    if img.ndim == 3:
        a = a[..., None]
    else:
        c = c[0]
    blended = np.floor(region * (1.0 - a) + c * a + 0.5)
    painted = cover > 0
    region[painted] = blended[painted].astype(np.uint8)
    return img
