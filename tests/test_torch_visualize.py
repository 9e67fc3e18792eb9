"""The port's visualization layer against dream_tpu's, on the CPU.

``dream_tpu`` draws with cv2, matplotlib and PIL; the port with its own
versions of their algorithms (``utils/raster.py``, ``utils/colormaps.py``,
``utils/resample.py``).  Inputs are drawn from numpy seeds, and the
hypothesis test runs derandomized.

- Pixel-equal (no difference): dots (``overlay_points_on_image`` without
  names: random subpixel centres, negative and off-image ones, sentinels,
  NaN, diameters 4, 6 and per-point lists, filled and outlined), OpenCV's
  ``circle`` and ``line`` themselves (thickness 1-5, ends off the image),
  ``image_from_belief_map`` under its 7 normalization methods with NaN and
  out-of-range values, matplotlib's colormap and the colour names,
  ``mosaic_images`` with padding, ``image_from_tensor``,
  ``blend_belief_overlay`` (100x100 -> 640x480), ``overlay_pose_triad`` on
  random poses, Pillow's resize, blend, crop and paste, every ``pil_compat``
  function for every preprocessing type and its inverse at 640x480 <->
  400x400, and ``sample_range_analysis``'s files (4 and 17 keypoints).
- Text, held loosely (``TEXT_SHARE``, ``TEXT_MARGIN``): where names are
  drawn, the port's pixels differ from cv2's on at most 10% of the pixels
  cv2 paints for the names, and on none outside a 2-pixel margin of cv2's
  text boxes (``cv2.getTextSize``).  The glyphs come from an atlas of
  cv2's own coverage (``scripts/make_text_atlas.py``); strings differ only
  where glyphs' antialiased edges overlap.
"""

import os
import subprocess
import sys

import cv2
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
import webcolors
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from dream_tpu import visualize as jviz
from dream_tpu.analysis import sample_range_analysis as jax_sample_range_analysis
from dream_tpu.ops import pil_compat as jpil

from dream_tpu_torch import analysis
from dream_tpu_torch import visualize as viz
from dream_tpu_torch.ops import pil_compat
from dream_tpu_torch.utils import colormaps, raster, resample
from dream_tpu_torch.utils.png import decode_png, encode_png, read_png

TEXT_SHARE = 0.10
TEXT_MARGIN = 2
PANDA_NAMES = ["panda_link0", "panda_link2", "panda_link3", "panda_link4", "panda_link6",
               "panda_link7", "panda_hand"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _points(rng, n, w, h):
    """Subpixel points over and beyond a w x h image, with a sentinel, a NaN
    and a point at negative fractional coordinates."""
    pts = np.stack([rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)], 1)
    pts[0] = (-999.999, -999.999)
    pts[1] = (np.nan, 3.0)
    pts[2] = (-0.3, -0.7)
    pts[3] = (rng.uniform(0, w), np.inf)
    return pts


@pytest.mark.parametrize("seed", range(3))
def test_overlay_points_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = 60, 80
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    pts = _points(rng, 16, w, h)
    before = image.copy()
    cases = [dict(), dict(point_diameter=4.0), dict(point_diameter=list(rng.choice([4.0, 6.0, 9.5], 16))),
             dict(annotation_color_dot=["green", "blue", (12, 200, 7), "orange"] * 4),
             dict(annotation_color_dot="LightSeaGreen", point_diameter=6),
             dict(point_thickness=1), dict(point_thickness=2, point_diameter=11.0)]
    for kwargs in cases:
        ours = viz.overlay_points_on_image(image, pts, **kwargs)
        ref = np.asarray(jviz.overlay_points_on_image(image, pts, **kwargs))
        np.testing.assert_array_equal(ours, ref, err_msg=str(kwargs))
    # float32 points, a torch image and a list of points draw the same.
    ref = np.asarray(jviz.overlay_points_on_image(image, pts.astype(np.float32)))
    np.testing.assert_array_equal(
        viz.overlay_points_on_image(torch.from_numpy(image), list(pts.astype(np.float32))), ref)
    np.testing.assert_array_equal(image, before)
    assert viz.overlay_points_on_image(image, []).tolist() == image.tolist()


@settings(max_examples=150, derandomize=True, deadline=None, database=None)
@given(x=st.floats(-12.0, 92.0), y=st.floats(-12.0, 72.0), diameter=st.sampled_from([4.0, 6.0]))
def test_one_dot_matches_cv2(x, y, diameter):
    image = np.zeros((60, 80, 3), np.uint8)
    ours = viz.overlay_points_on_image(image, [(x, y)], point_diameter=diameter)
    ref = np.asarray(jviz.overlay_points_on_image(image, [(x, y)], point_diameter=diameter))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed", range(2))
def test_raster_matches_cv2(seed):
    rng = np.random.RandomState(seed)
    h, w = 50, 70
    for _ in range(150):
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p0 = tuple(int(v) for v in rng.uniform(-30, 100, 2))
        p1 = tuple(int(v) for v in rng.uniform(-30, 100, 2))
        thickness = int(rng.randint(1, 6))
        np.testing.assert_array_equal(raster.line(image.copy(), p0, p1, (0, 255, 0), thickness),
                                      cv2.line(image.copy(), p0, p1, (0, 255, 0), thickness),
                                      err_msg=f"line {p0} {p1} {thickness}")
        center = tuple(int(v) for v in rng.uniform(-10, 80, 2))
        radius = int(rng.randint(0, 25))
        for t in (-1, 1, 3):
            np.testing.assert_array_equal(raster.circle(image.copy(), center, radius, (255, 0, 0), t),
                                          cv2.circle(image.copy(), center, radius, (255, 0, 0), t),
                                          err_msg=f"circle {center} {radius} {t}")
        sub = tuple(int(v) for v in rng.uniform(-200, 1400, 2))
        radius = int(rng.randint(0, 400))
        t = int(rng.choice([-1, 1, 2]))
        np.testing.assert_array_equal(raster.circle(image.copy(), sub, radius, 7, t, shift=4),
                                      cv2.circle(image.copy(), sub, radius, (7, 0, 0), t, shift=4),
                                      err_msg=f"circle {sub} {radius} {t} shift 4")


def _belief_maps(rng, n=3, h=40, w=50):
    maps = rng.normal(0.0, 0.05, (n, h, w)).astype(np.float32)
    ys, xs = np.mgrid[:h, :w]
    for m in maps:
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        m += np.float32(rng.uniform(0.5, 1.6)) * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 8.0).astype(np.float32)
    return maps


@pytest.mark.parametrize("method", range(7))
def test_image_from_belief_map_matches_jax(method):
    rng = np.random.RandomState(10 + method)
    maps = _belief_maps(rng)
    maps[1, 3, 4] = np.float32(1.0)  # x == 1 maps to the last colour
    maps[1, 5, 6] = np.float32(0.99999994)
    maps[1, 7, 8:12] = [-np.inf, np.inf, 7.5, -3.0]
    maps[2, 0, 0] = np.nan
    for m in maps:
        ours = viz.image_from_belief_map(m, normalization_method=method)
        ref = np.asarray(jviz.image_from_belief_map(m, normalization_method=method))
        np.testing.assert_array_equal(ours, ref)
    clean = np.clip(maps[0], 0.0, 1.0)
    np.testing.assert_array_equal(viz.image_from_belief_map(clean[None], colormap=None),
                                  np.asarray(jviz.image_from_belief_map(clean[None], colormap=None)))
    for ours, ref in zip(viz.images_from_belief_maps(torch.from_numpy(maps[:1])),
                         jviz.images_from_belief_maps(maps[:1])):
        np.testing.assert_array_equal(ours, np.asarray(ref))


def test_colormap_and_names_match_matplotlib_and_webcolors():
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 20000),
                        np.arange(2 ** 12) / 2 ** 12, [np.nan, np.inf, -np.inf, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(colormaps.colormap_rgba(x), plt.get_cmap("inferno")(x))
    np.testing.assert_array_equal(colormaps.colormap_rgba(x.astype(np.float64)),
                                  plt.get_cmap("inferno")(x.astype(np.float64)))
    for name in webcolors.names("css3"):
        assert colormaps.to_rgb(name) == tuple(webcolors.name_to_rgb(name)), name
    assert colormaps.to_rgb("Red") == (255, 0, 0) and colormaps.to_rgb("green") == (0, 128, 0)
    with pytest.raises(ValueError):
        colormaps.to_rgb("nonsense")
    with pytest.raises(ValueError):
        colormaps.colormap_rgba(x, "viridis")


def test_mosaic_and_image_from_tensor_match_jax():
    rng = np.random.RandomState(5)
    images = [rng.randint(0, 256, (20, 30, 3)).astype(np.uint8) for _ in range(5)]
    for kwargs in (dict(rows=2), dict(cols=3, outer_padding_px=3, inner_padding_px=4),
                   dict(rows=1, cols=5, inner_padding_px=10, fill_color_rgb=(1, 2, 3))):
        ref = jviz.mosaic_images([Image.fromarray(a) for a in images], **kwargs)
        np.testing.assert_array_equal(viz.mosaic_images(images, **kwargs), np.asarray(ref))
    norm = {"mean": [0.485, 0.456, 0.406], "stdev": [0.229, 0.224, 0.225]}
    x = rng.normal(0.0, 1.5, (2, 16, 16, 3)).astype(np.float32)
    x[0, 0, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255]  # ties to even
    for normalization in (None, norm):
        for ours, ref in zip(viz.images_from_tensor(torch.from_numpy(x), normalization),
                             jviz.images_from_tensor(x, normalization)):
            np.testing.assert_array_equal(ours, np.asarray(ref))


def test_blend_belief_overlay_matches_jax():
    rng = np.random.RandomState(6)
    image = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    bm = _belief_maps(rng, n=1, h=100, w=100)[0]
    ref = jviz.blend_belief_overlay(Image.fromarray(image), bm)
    np.testing.assert_array_equal(viz.blend_belief_overlay(image, bm), np.asarray(ref))
    ref = jviz.blend_belief_overlay(Image.fromarray(image[:400, :400]), bm, alpha=0.3,
                                    normalization_method=0)
    np.testing.assert_array_equal(
        viz.blend_belief_overlay(image[:400, :400], bm, alpha=0.3, normalization_method=0),
        np.asarray(ref))


def test_overlay_pose_triad_matches_jax():
    rng = np.random.RandomState(7)
    K = np.array([[615.0, 0.0, 320.0], [0.0, 615.0, 240.0], [0.0, 0.0, 1.0]])
    image = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    drawn = 0
    for i in range(12):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = [rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4), rng.uniform(0.15, 2.0)]
        if i == 0:
            t[2] = 0.05  # an axis behind the camera: the image as it was
        if i % 2:
            q, t = q.tolist(), list(t)
        ours = viz.overlay_pose_triad(image, K, t, q)
        ref = np.asarray(jviz.overlay_pose_triad(Image.fromarray(image), K, t, q))
        np.testing.assert_array_equal(ours, ref)
        drawn += int(not np.array_equal(ours, image))
    assert drawn >= 8


def test_resample_matches_pillow():
    rng = np.random.RandomState(8)
    sizes = [((100, 100), (640, 480)), ((100, 100), (400, 400)), ((640, 480), (400, 400)),
             ((480, 480), (400, 400)), ((400, 400), (640, 480)), ((37, 53), (11, 7)),
             ((7, 5), (300, 2)), ((1000, 17), (3, 90))]
    for (w, h), size in sizes:
        for shape in ((h, w, 3), (h, w)):
            a = rng.randint(0, 256, shape).astype(np.uint8)
            ref = Image.fromarray(a).resize(size, resample=Image.BILINEAR)
            np.testing.assert_array_equal(resample.resize(a, size), np.asarray(ref), err_msg=str(size))
    a, b = (rng.randint(0, 256, (30, 40, 3)).astype(np.uint8) for _ in range(2))
    for alpha in (0.5, 0.3, 0.77, 0.0, 1.0, 1.5, -0.2):
        ref = Image.blend(Image.fromarray(a), Image.fromarray(b), alpha)
        np.testing.assert_array_equal(resample.blend(a, b, alpha), np.asarray(ref))
    for box in ((5, 7, 30, 25), (-5, -3, 20, 20), (35, 25, 50, 40)):
        np.testing.assert_array_equal(resample.crop(a, box), np.asarray(Image.fromarray(a).crop(box)))
    canvas = Image.new("RGB", (30, 20), (1, 2, 3))
    canvas.paste(Image.fromarray(a), (-4, 5))
    np.testing.assert_array_equal(resample.paste(resample.new((30, 20), (1, 2, 3)), a, (-4, 5)),
                                  np.asarray(canvas))


@pytest.mark.parametrize("preprocessing", ["none", "resize", "shrink", "shrink-and-crop"])
def test_pil_compat_matches_jax(preprocessing):
    rng = np.random.RandomState(9)
    raw = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    pil = Image.fromarray(raw)
    ours = pil_compat.preprocess_image(raw, (400, 400), preprocessing)
    ref = jpil.preprocess_image(pil, (400, 400), preprocessing)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    back = pil_compat.inverse_preprocess_image(ours, (640, 480), preprocessing)
    np.testing.assert_array_equal(back, np.asarray(jpil.inverse_preprocess_image(ref, (640, 480),
                                                                                  preprocessing)))
    assert back.shape == (480, 640, 3)
    if preprocessing == "shrink-and-crop":
        for kwargs in (dict(factor=0.37), dict(new_width=123), dict(new_height=77)):
            np.testing.assert_array_equal(pil_compat.scale_image(raw, **kwargs),
                                          np.asarray(jpil.scale_image(pil, **kwargs)))
        np.testing.assert_array_equal(pil_compat.crop_image(raw, 13, 7, 100, 50),
                                      np.asarray(jpil.crop_image(pil, 13, 7, 100, 50)))
        crop, corner = pil_compat.centered_crop_image(raw, 401, 333)
        ref_crop, ref_corner = jpil.centered_crop_image(pil, 401, 333)
        assert corner == ref_corner
        np.testing.assert_array_equal(crop, np.asarray(ref_crop))
        np.testing.assert_array_equal(pil_compat.shrink_and_crop_image(raw, (400, 400)),
                                      np.asarray(jpil.shrink_and_crop_image(pil, (400, 400))))
        small = ours[:100, :100]
        np.testing.assert_array_equal(
            pil_compat.convert_image_to_netin_from_netout(small, (400, 400)),
            np.asarray(jpil.convert_image_to_netin_from_netout(Image.fromarray(small), (400, 400))))
        np.testing.assert_array_equal(
            pil_compat.convert_image_to_netout_from_netin(ours, (100, 100)),
            np.asarray(jpil.convert_image_to_netout_from_netin(Image.fromarray(ours), (100, 100))))
        with pytest.raises(ValueError):
            pil_compat.preprocess_image(raw, (400, 400), "nonsense")


def _text_boxes(points, names):
    """cv2's text boxes: (x0, y0, x1, y1), one a drawn name."""
    boxes = []
    for p, name in zip(points, names):
        if p[0] < -999.0 or p[1] < -999.0 or not np.all(np.isfinite(p)):
            continue
        (w, h), base = cv2.getTextSize(name, cv2.FONT_HERSHEY_SIMPLEX, 0.75, 2)
        x, y = int(p[0]) + 10, int(p[1])
        boxes.append((x, y - h, x + w, y + base))
    return boxes


def assert_equal_but_names(ours, ref, image, points, names):
    """``ours`` equals dream_tpu's overlay ``ref`` of ``points`` and their
    ``names`` on ``image`` but where the names are drawn, and there within
    the loose text bound."""
    dots = np.asarray(jviz.overlay_points_on_image(image, points))
    painted = (ref != dots).any(-1)
    differ = (ours != ref).any(-1)
    near = np.zeros(differ.shape, bool)
    for x0, y0, x1, y1 in _text_boxes(points, names):
        near[max(y0 - TEXT_MARGIN, 0):max(y1 + TEXT_MARGIN, 0),
             max(x0 - TEXT_MARGIN, 0):max(x1 + TEXT_MARGIN, 0)] = True
    assert not (differ & ~near).any(), "pixels differ away from the names"
    assert differ.sum() <= TEXT_SHARE * painted.sum(), (differ.sum(), painted.sum())
    return painted.sum()


@pytest.mark.parametrize("seed", range(3))
def test_text_matches_cv2_loosely(seed):
    rng = np.random.RandomState(20 + seed)
    h, w = 240, 320
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    pts = _points(rng, 7, w, h)
    pts[4] = (w - 30.5, 12.25)  # a name running off the image
    chars = [chr(c) for c in range(32, 127)]
    names = PANDA_NAMES if seed == 0 else ["".join(rng.choice(chars, rng.randint(1, 12)))
                                            for _ in range(7)]
    colors = ["red", "yellow", (10, 240, 30), "white", "magenta", "cyan", "black"]
    ours = viz.overlay_points_on_image(image, pts, names, annotation_color_text=colors)
    ref = np.asarray(jviz.overlay_points_on_image(image, pts, names, annotation_color_text=colors))
    assert assert_equal_but_names(ours, ref, image, pts, names) > 200


def test_png_bytes_round_trip():
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (33, 47, 3)).astype(np.uint8)
    data = encode_png(image)
    np.testing.assert_array_equal(decode_png(data), image)
    np.testing.assert_array_equal(np.asarray(Image.open(__import__("io").BytesIO(data))), image)


@pytest.mark.parametrize("n_keypoints", [4, 17])
def test_sample_range_analysis_matches_jax(tmp_path, n_keypoints):
    import jax.numpy as jnp

    from dream_tpu.ops.belief_maps import create_belief_maps

    rng = np.random.RandomState(n_keypoints)
    kp = np.stack([rng.uniform(2, 30, (2, n_keypoints)), rng.uniform(2, 22, (2, n_keypoints))], -1)
    kp[1, 0] = (-999.999, -999.999)
    maps = np.asarray(create_belief_maps(jnp.asarray(kp, jnp.float32), (32, 24)))  # [2, n, 24, 32]
    net_in = rng.uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    names = [f"kp{i}" for i in range(n_keypoints)]
    args = dict(raw_images=[None, None], sample_kp_proj_detected_netout=kp,
                sample_kp_proj_gt_netout=kp + 1.0, sample_belief_maps=maps,
                sample_names=["000001", "000004"], sample_ranks=[0, 3], image_prefix="best",
                keypoint_names=names)
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    analysis.sample_range_analysis(output_dir=str(ours_dir), images_net_input=net_in, **args)
    jax_sample_range_analysis(output_dir=str(ref_dir), images_net_input=net_in, **args)
    files = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(ours_dir)) == files and len(files) == 6
    assert "best_belief_maps_kp_rank_3_id_000004.png" in files
    for f in files:
        np.testing.assert_array_equal(read_png(str(ours_dir / f)),
                                      np.asarray(Image.open(ref_dir / f).convert("RGB")), err_msg=f)
    n_cols = -(-n_keypoints // 2)
    assert read_png(str(ours_dir / files[0])).shape == (2 * 24 + 10, n_cols * 32 + (n_cols - 1) * 10, 3)


def test_drawing_imports_no_host_library():
    """In a fresh interpreter, drawing through the port loads none of the
    libraries dream_tpu draws with."""
    code = (
        "import sys, numpy as np\n"
        "from dream_tpu_torch import visualize as viz\n"
        "from dream_tpu_torch.ops import pil_compat\n"
        "from dream_tpu_torch.cli import network_inference, visualize_network_inference\n"
        "img = viz.overlay_points_on_image(np.zeros((48, 64, 3), np.uint8), [(10.5, 20.25)], ['a'])\n"
        "img = viz.blend_belief_overlay(img, np.ones((8, 8), np.float32))\n"
        "img = viz.overlay_pose_triad(img, np.eye(3) * 50 + [[0, 0, 32], [0, 0, 24], [0, 0, -49]],\n"
        "                             [0, 0, 1.0], [0, 0, 0, 1.0])\n"
        "pil_compat.preprocess_image(img, (32, 32), 'shrink-and-crop')\n"
        "print(sorted(m for m in ('cv2', 'PIL', 'matplotlib', 'webcolors', 'jax', 'dream_tpu')\n"
        "             if m in sys.modules))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
