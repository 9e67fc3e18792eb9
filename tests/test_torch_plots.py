"""The port's plots against dream_tpu's and matplotlib's, on the CPU.

- ``pck_curve_from_csv`` and ``add_curve_from_csv`` (with and without
  ``--divide``) return ``dream_tpu``'s arrays, AUCs and counts exactly on
  the same CSVs (written by the port's writers from seeded draws, sentinel
  rows and out-of-frame keypoints included), and each ``main`` prints
  ``dream_tpu``'s lines, the output path aside: the port's CSV reader
  parses numbers as pandas does, to the bit (held on 60,000 numbers).
- ``plot_train_valid_loss`` draws ``dream_tpu``'s series (both branches:
  floats, and per-batch lists drawn as mean +- std error bars) with its
  title, labels and limits.
- The renderer against matplotlib 3.10 on the same calls (lines in every
  style the callers use, error bars, a filled band, explicit and automatic
  limits, one-epoch limits, an empty legend spacer): the axes box in pixels
  within 1 px, the view limits and the visible tick values exactly, the
  legend's location and its anchored corner (within 1 px; its size is laid
  out with DejaVu Sans's metrics, so within a few px) for ``best`` and
  ``lower right``, and each line's coloured pixels within 2 px of
  matplotlib's (mean symmetric Chamfer distance over the pixels within 40
  of the line's colour on every channel, outside the legend).
- The PDF parses: header, an xref table whose offsets point at its objects,
  ``startxref``, one ``% series`` path per series.  Other extensions
  raise; none gets ``.png``.
- ``analyze_training`` and ``analyze_training_multi`` on two tiny runs
  write the files ``dream_tpu``'s scripts write, under the same names
  (the JAX scripts run their loss analyses; the evaluation's files are
  ``analyze_ndds_dataset``'s, held against ``dream_tpu``'s in
  ``tests/test_torch_cli.py``).
"""

import contextlib
import copy
import importlib.util
import io
import os
import pickle
import re

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy import ndimage  # noqa: E402

from dream_tpu import add_plots as jax_add_plots  # noqa: E402
from dream_tpu import analysis as jax_analysis  # noqa: E402
from dream_tpu import oks_plots as jax_oks_plots  # noqa: E402

from dream_tpu_torch import add_plots, analysis, oks_plots  # noqa: E402
from dream_tpu_torch.cli import analyze_training, analyze_training_multi  # noqa: E402
from dream_tpu_torch.data.synthetic import generate_synthetic_ndds  # noqa: E402
from dream_tpu_torch.network import DreamNetwork  # noqa: E402
from dream_tpu_torch.utils.config import load_yaml  # noqa: E402
from dream_tpu_torch.utils.csv_table import parse_float  # noqa: E402
from dream_tpu_torch.utils.plot import TAB10, Plot, tick_values  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    rng = np.random.RandomState(0)
    out = {}
    for i in range(2):
        n = 40
        names = [f"{k:06d}" for k in range(n)]
        gt = rng.uniform(-40, 680, (n, 7, 2))
        det = gt + rng.normal(0, 4 + 3 * i, gt.shape)
        det[rng.rand(n, 7) < 0.1] = -999.999
        kp = str(root / f"keypoints_{i}.csv")
        analysis.write_keypoint_csv(kp, names, det, gt)
        add = rng.exponential(0.02 + 0.01 * i, n)
        add[rng.rand(n) < 0.15] = -999.0
        n_inframe = rng.randint(2, 8, n)
        pnp = str(root / f"pnp_results_{i}.csv")
        analysis.write_pnp_csv(pnp, names, add > -999, rng.normal(size=(n, 7)), add, n_inframe)
        cm = str(root / f"pnp_cm_{i}.csv")
        analysis.write_pnp_csv(cm, names, add > -999, rng.normal(size=(n, 7)),
                               np.where(add > -999, add * 100.0, -999.0), n_inframe)
        out[i] = {"kp": kp, "pnp": pnp, "cm": cm}
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_pck_curve_matches_dream_tpu(csvs, i):
    ours = oks_plots.pck_curve_from_csv(csvs[i]["kp"], 7, (640, 480), 20.0)
    ref = jax_oks_plots.pck_curve_from_csv(csvs[i]["kp"], 7, (640, 480), 20.0)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("divide", [False, True])
def test_add_curve_matches_dream_tpu(csvs, divide):
    path = csvs[0]["cm" if divide else "pnp"]
    ours = add_plots.add_curve_from_csv(path, 0.1, divide)
    ref = jax_add_plots.add_curve_from_csv(path, 0.1, divide)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_csv_numbers_parse_as_pandas_parses_them():
    import pandas as pd

    rng = np.random.RandomState(0)
    values = np.concatenate([rng.exponential(0.03, 20000), rng.uniform(-40, 680, 20000),
                             rng.normal(0, 1, 20000) * 10.0 ** rng.randint(-8, 5, 20000),
                             [-999.0, -999.999, 0.0, 1e-300, 123456789012345678901.0]])
    text = [repr(float(v)) for v in values] + ["7", "-0.5", "+3.25e+02", ".5", "nan"]
    ref = pd.read_csv(io.StringIO("a\n" + "\n".join(text)))["a"].to_numpy()
    ours = np.array([parse_float(t) for t in text])
    np.testing.assert_array_equal(ours, ref)


def _printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    plt.close("all")
    return [line for line in buf.getvalue().splitlines() if not line.startswith("Saved plot to")]


@pytest.mark.parametrize("tool", ["oks", "add"])
def test_main_prints_dream_tpu_lines(csvs, tool, tmp_path):
    key = "kp" if tool == "oks" else "pnp"
    ours_mod, ref_mod = (oks_plots, jax_oks_plots) if tool == "oks" else (add_plots, jax_add_plots)
    argv = ["--data", csvs[0][key], "666", csvs[1][key], "--labels", "run_a", "spacer", "run_b",
            "--styles", ":", "-", ".-", "--title", "A title"]
    ours = _printed(ours_mod.main, argv + ["--output", str(tmp_path / "ours.pdf")])
    ref = _printed(ref_mod.main, argv + ["--output", str(tmp_path / "ref.pdf")])
    assert ours == ref and len(ours) >= 8
    assert os.path.getsize(tmp_path / "ours.pdf") > 0
    with pytest.raises(RuntimeError, match="window"):
        ours_mod.main(argv + ["--show"])


def _mpl_axes(fig, ax):
    fig.canvas.draw()
    b = ax.get_window_extent()
    return b.x0, b.y0, b.x1, b.y1


def _visible(ticks, lim):
    lo, hi = min(lim), max(lim)
    return [t for t in ticks if lo - 1e-10 * (hi - lo) <= t <= hi + 1e-10 * (hi - lo)]


def _epochs_case(rng, n_epochs):
    e = list(range(1, n_epochs + 1))
    train = [list(np.exp(-k / 6) + 0.05 * rng.rand(3)) for k in e]
    valid = [list(np.exp(-k / 6) + 0.1 + 0.05 * rng.rand(2)) for k in e]
    return e, train, valid


@pytest.mark.parametrize("batchwise", [False, True])
def test_plot_train_valid_loss_draws_dream_tpu_series(batchwise, tmp_path):
    e, train, valid = _epochs_case(np.random.RandomState(4), 6)
    if not batchwise:
        train, valid = [float(np.mean(x)) for x in train], [float(np.mean(x)) for x in valid]
    fig, ax = jax_analysis.plot_train_valid_loss(e, train, valid, dataset_name="run_a")
    ours = analysis.plot_train_valid_loss(e, train, valid, dataset_name="run_a",
                                          save_plot_path=str(tmp_path / "loss"))
    assert os.path.exists(tmp_path / "loss.png")
    if batchwise:
        labelled = [(c.get_label(), c.lines[0]) for c in ax.containers]
    else:
        labelled = [(line.get_label(), line) for line in ax.get_lines()]
    assert [s.label for s in ours.series] == [label for label, _ in labelled] == ["Training", "Validation"]
    for s, (_, line) in zip(ours.series, labelled):
        np.testing.assert_array_equal(s.x, np.asarray(line.get_xdata(), float))
        np.testing.assert_array_equal(s.y, np.asarray(line.get_ydata(), float))
    if batchwise:
        for s, data in zip(ours.series, (train, valid)):
            np.testing.assert_array_equal(s.yerr, [np.std(x) for x in data])
    assert ours.title == ax.get_title() and ours.xlabel == ax.get_xlabel()
    assert ours.ylabel == ax.get_ylabel()
    assert ours.view_limits() == (ax.get_xlim(), ax.get_ylim())
    plt.close(fig)


def _line_case(o, rng):
    v = np.arange(0.0, 0.1, 0.00001)
    c = np.clip(v * 12 + 0.02 * np.sin(v * 300), 0, 0.93)
    o.grid(True, alpha=0.3)
    o.plot([], [], " ", label="spacer")
    o.plot(v * 100, c, "-", label="vgg-Q (0.812)")
    o.plot(v * 100, c * 0.8, "--", label="vgg-F (0.700)")
    o.plot(v * 100, c * 0.6, ":", label="dotted")
    o.plot(v * 100, c * 0.4, "-.", label="dash-dot")
    o.set_ylim(0, 1)
    o.set_xlabel("ADD threshold distance (cm)")
    o.legend(loc="lower right")


def _band_case(o, rng):
    e = np.arange(1, 11)
    losses = np.exp(-e[None] / 4) + 0.1 * rng.rand(5, 10)
    m, s = losses.mean(0), losses.std(0)
    o.fill_between(e, m - s, m + s, alpha=0.333, label="Aggregate mean +- 1 std dev")
    o.plot(e, m, ".-", label="Aggregate mean")
    o.plot(e, losses.min(0), ".-", label="Aggregate min")
    o.grid()
    o.set_xlim((1, 10))
    o.legend(loc="best")


def _instances_case(o, rng):
    e = np.arange(1, 9)
    losses = 0.2 + 0.3 * np.exp(-e[None] / 3) + 0.05 * rng.rand(3, 8)
    o.plot(e, np.transpose(losses), ".-")
    o.plot(e, losses[1], "-", linewidth=8, alpha=0.667, label="Best training result")
    o.grid()
    o.legend(loc="best")


def _errorbar_case(o, rng):
    o.errorbar([1], [0.5], yerr=[0.1], marker=".", linestyle="-", label="Training")
    o.errorbar([1], [0.62], yerr=[0.05], marker=".", linestyle="-", label="Validation")
    o.grid()
    o.set_xlim((1, 1))
    o.legend(loc="best")


def _rising_case(o, rng):
    """Data in the upper right: best moves the legend elsewhere."""
    x = np.linspace(0, 3, 40)
    o.plot(x, x ** 2 + rng.rand(40) * 0.1, label="rising")
    o.plot(x, 9 - 0.5 * x, label="falling")
    o.legend(loc="best")


CASES = {"lines": _line_case, "band": _band_case, "instances": _instances_case,
         "errorbar": _errorbar_case, "rising": _rising_case}


def _both(case):
    fig, ax = plt.subplots()
    ours = Plot()
    for target in (ax, ours):
        CASES[case](target, np.random.RandomState(7))
    fig.canvas.draw()
    return fig, ax, ours


def _pixels_of(image, rgb, tol=40):
    return np.all(np.abs(image[..., :3].astype(int) - np.asarray(rgb)) <= tol, axis=-1)


def _chamfer(a, b):
    """Mean symmetric Chamfer distance in px between two pixel masks."""
    da, db = ndimage.distance_transform_edt(~a), ndimage.distance_transform_edt(~b)
    return 0.5 * (db[a].mean() + da[b].mean())


@pytest.mark.parametrize("case", list(CASES))
def test_renderer_geometry_matches_matplotlib(case):
    fig, ax, ours = _both(case)
    np.testing.assert_allclose(ours.axes_box(), _mpl_axes(fig, ax), atol=1.0)
    assert ours.view_limits() == (ax.get_xlim(), ax.get_ylim())
    xt, yt = ours.ticks()
    assert list(xt) == _visible(ax.get_xticks(), ax.get_xlim())
    assert list(yt) == _visible(ax.get_yticks(), ax.get_ylim())
    legend = ax.get_legend()
    name, (l, b, r, t) = ours.legend_box()
    box = legend.get_window_extent()
    assert abs((r - l) - box.width) <= 4 and abs((t - b) - box.height) <= 1
    loc = name.split()
    # The corner the location anchors: its vertical and horizontal sides.
    ys = {"upper": (t, box.y1), "lower": (b, box.y0)}
    xs = {"right": (r, box.x1), "left": (l, box.x0)}
    for word in loc:
        if word in ys:
            assert abs(ys[word][0] - ys[word][1]) <= 1, (name, case)
        if word in xs:
            assert abs(xs[word][0] - xs[word][1]) <= 1, (name, case)
    if case == "rising":
        assert name != "upper right"
    plt.close(fig)


@pytest.mark.parametrize("case", ["lines", "band", "instances", "errorbar"])
def test_renderer_curves_lie_on_matplotlibs(case):
    fig, ax, ours = _both(case)
    ref = np.asarray(fig.canvas.buffer_rgba())
    image = ours.render()
    assert image.shape == (480, 640, 3) and ref.shape[:2] == (480, 640)
    lb = ax.get_legend().get_window_extent()
    outside = np.ones((480, 640), bool)
    outside[int(480 - lb.y1) - 2:int(480 - lb.y0) + 3, int(lb.x0) - 2:int(lb.x1) + 3] = False
    colours = {s.color for s in ours.series if s.kind == "line" and len(s.x) and s.style}
    assert colours
    seen = 0
    for colour in colours:
        rgb = [int(colour[i:i + 2], 16) for i in (1, 3, 5)]
        a, b = _pixels_of(image, rgb) & outside, _pixels_of(ref, rgb) & outside
        if b.sum() <= 20:  # covered in matplotlib's figure too (a wide line drawn over it)
            continue
        seen += 1
        assert a.sum() > 20, colour
        assert _chamfer(a, b) <= 2.0, (case, colour, _chamfer(a, b))
    assert seen
    plt.close(fig)


def test_tick_values_are_matplotlibs():
    from matplotlib.ticker import MaxNLocator

    locator = MaxNLocator(nbins=9, steps=[1, 2, 2.5, 5, 10])
    rng = np.random.RandomState(3)
    for _ in range(300):
        lo = rng.uniform(-1e3, 1e3) * 10.0 ** rng.randint(-6, 3)
        hi = lo + abs(rng.uniform(0, 1e3)) * 10.0 ** rng.randint(-7, 3) + 1e-12
        np.testing.assert_array_equal(tick_values(lo, hi), locator.tick_values(lo, hi))


def test_colour_cycles_are_matplotlibs():
    fig, ax = plt.subplots()
    ours = Plot()
    for target in (ax, ours):
        target.fill_between([0, 1], [0, 1], [1, 2])
        for _ in range(11):
            target.plot([0, 1], [0, 1])
    poly = ax.collections[0].get_facecolor()[0][:3]
    assert ours.series[0].color == matplotlib.colors.to_hex(poly)
    assert [s.color for s in ours.series[1:]] == [line.get_color() for line in ax.get_lines()]
    assert ours.series[-1].color == TAB10[0]
    plt.close(fig)


def test_pdf_parses_and_formats_follow_the_extension(tmp_path):
    fig, ax, ours = _both("lines")
    plt.close(fig)
    path = ours.savefig(str(tmp_path / "plot.pdf"))
    data = open(path, "rb").read()
    assert data.startswith(b"%PDF-1.4") and data.rstrip().endswith(b"%%EOF")
    startxref = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    assert data[startxref:].startswith(b"xref")
    entries = re.findall(rb"(\d{10}) 00000 n ", data[startxref:])
    assert len(entries) == 5
    for number, offset in enumerate(entries, 1):
        assert data[int(offset):].startswith(b"%d 0 obj" % number)
    stream = re.search(rb"stream\n(.*)\nendstream", data, re.S).group(1)
    length = int(re.search(rb"/Length (\d+)", data).group(1))
    assert length == len(stream)
    series = re.findall(rb"% series (.*)\n", stream)
    assert series == [b"vgg-Q \\(0.812\\)", b"vgg-F \\(0.700\\)", b"dotted", b"dash-dot"]
    assert b"/BaseFont /Helvetica" in data and b"(ADD threshold distance \\(cm\\)) Tj" in stream
    assert ours.savefig(str(tmp_path / "plain")) == str(tmp_path / "plain.png")
    assert open(tmp_path / "plain.png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="svg"):
        ours.savefig(str(tmp_path / "plot.svg"))


@pytest.fixture(scope="module")
def two_runs(tmp_path_factory):
    """Two tiny training runs: a saved 64x64 vgg-Q, its sidecar naming an
    8-frame dataset, and a training log each."""
    root = tmp_path_factory.mktemp("runs")
    data = generate_synthetic_ndds(str(root / "data"), n_frames=8, image_resolution=(160, 120),
                                   seed=3, out_of_frame_fraction=0.0)
    cfg = load_yaml(os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml"))
    cfg["architecture"]["compute_dtype"] = "float32"
    tcfg = cfg["training"]["config"]
    tcfg["net_input_resolution"] = [64, 64]
    tcfg.pop("net_output_resolution")
    tcfg["image_raw_resolution"] = [160, 120]
    cfg["data_path"] = data
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    runs = root / "runs"
    rng = np.random.RandomState(6)
    for i, name in enumerate(("seed_1", "seed_2")):
        net.save_network(str(runs / name), "best_network")
        e, train, valid = _epochs_case(rng, 4)
        with open(runs / name / "training_log.pkl", "wb") as f:
            pickle.dump({"epochs": e, "losses": [float(np.mean(x)) for x in train],
                         "validation_losses": [float(np.mean(x)) for x in valid],
                         "batch_training_losses": train, "batch_validation_losses": valid,
                         "random_seed": i + 1}, f)
    return runs


def test_analyze_training_writes_dream_tpus_files(two_runs, tmp_path):
    params = str(two_runs / "seed_1" / "best_network.msgpack")
    analyze_training.analyze_training(analyze_training.make_parser().parse_args(
        ["-i", params, "-o", str(tmp_path / "ours"), "-b", "4", "--device", "cpu"]))
    script = _script("analyze_training")
    import argparse

    script.analyze_training(argparse.Namespace(
        input_params_path=params, input_config_path=None, output_dir=str(tmp_path / "ref"),
        force_overwrite=False, analyses=["loss"], batch_size=4))
    plt.close("all")
    ours = set(os.listdir(tmp_path / "ours"))
    assert set(os.listdir(tmp_path / "ref")) == {"train_valid_loss.png"} <= ours
    assert {"keypoints.csv", "pnp_results.csv", "analysis_results.txt", "best_samples.png",
            "medians_samples.png", "worst_samples.png"} <= ours


def test_analyze_training_multi_writes_dream_tpus_files(two_runs, tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        figures = analyze_training_multi.analyze_training_multi(
            analyze_training_multi.make_parser().parse_args(["-i", str(two_runs), "-o", str(tmp_path / "ours")]))
    ours_text = buf.getvalue()
    buf = io.StringIO()
    import argparse

    with contextlib.redirect_stdout(buf):
        _script("analyze_training_multi").analyze_training_multi(argparse.Namespace(
            input_dir=str(two_runs), output_dir=str(tmp_path / "ref"), force_overwrite=False))
    plt.close("all")
    assert ours_text == buf.getvalue()
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref")) == [
        "train_valid_loss_seed_1.png", "train_valid_loss_seed_2.png",
        "training_results_aggregate.png", "training_results_instances.png"]
    assert len(figures["aggregate"].series) == 5 and figures["aggregate"].series[0].kind == "fill"
    with pytest.raises(RuntimeError, match="window"):
        analyze_training_multi.analyze_training_multi(
            analyze_training_multi.make_parser().parse_args(["-i", str(two_runs)]))
