"""A cell, a configuration, a traffic mix and a per-layer metric are files
and entries: the harness lists and loads a new one with no code edited."""

import json
import shutil
from pathlib import Path

from benchmark.harness import cells

ROOT = Path(__file__).resolve().parents[2]


def test_a_cell_added_as_files_is_listed_and_loaded(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.eval_small", "config": "tiny", "traffic": "eval_small",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "jobs_seen.eval", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "evaluation loop",
                               "moves": "eval_frames_per_s", "workloads": ["tiny.eval_small"]})
    bench["end_to_end"][1]["workloads"].append("tiny.eval_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    config = json.loads((ROOT / "benchmark/configs/vgg_q.json").read_text())
    config["network"]["training"]["config"]["net_input_resolution"] = [64, 64]
    (tmp_path / "benchmark/configs/tiny.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "benchmark/traffic/eval_realsense.json").read_text())
    traffic["job_frames"] = 24
    (tmp_path / "benchmark/traffic/eval_small.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/checks/tiny.eval_small.json").write_text(
        json.dumps({"numbers": {"kp_gap_px": {"limit": 1.0}}}))
    (tmp_path / "benchmark/metrics/jobs_seen.eval.py").write_text(
        "def read(run):\n    return run['stats'].get('jobs')\n")

    resolved = cells.resolve("tiny.eval_small", tmp_path)
    assert resolved["config"]["network"]["training"]["config"]["net_input_resolution"] == [64, 64]
    assert resolved["traffic"]["job_frames"] == 24
    assert hasattr(resolved["driver"], "window")
    assert [m["name"] for m in cells.end_to_end("tiny.eval_small", tmp_path)] == ["eval_frames_per_s", "setup_s"]
    listed = [m["name"] for m in cells.per_layer("tiny.eval_small", tmp_path)]
    assert listed == ["jobs_seen.eval"]
    assert cells.metric_reader("jobs_seen.eval", tmp_path).read({"stats": {"jobs": 3}}) == 3


def test_every_metric_and_cell_of_the_benchmark_has_its_files():
    bench = cells.benchmark(ROOT)
    for cell in bench["workloads"]:
        resolved = cells.resolve(cell["name"], ROOT)
        assert resolved["checks"]["numbers"]
        assert cells.end_to_end(cell["name"], ROOT)[-1]["name"] == "setup_s"
        assert cells.per_layer(cell["name"], ROOT)
    for metric in bench["per_layer"]:
        assert callable(cells.metric_reader(metric["name"], ROOT).read)
