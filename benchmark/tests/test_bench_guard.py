"""The run's guards: no JAX and no JAX package, and no result without a card."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "benchmark"))

import run  # noqa: E402


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["jax.numpy", "dream_tpu_torch.network", "dream_tpu_torchvision", "jaxtyping", "flax",
              "optax.schedules", "dream_tpu", "numpy"]
    assert run.forbidden_modules(loaded) == ["dream_tpu", "flax", "jax", "optax"]
    assert run.forbidden_modules(["dream_tpu_torch", "dream_tpu_torch.ops.warp", "torch"]) == []


def test_the_port_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "import dream_tpu_torch.network, dream_tpu_torch.analysis; "
            "from benchmark.harness import cells, trace, program, render, yardstick, checks; "
            "from benchmark.drivers import train_scan, eval_frames; "
            "print(','.join(run.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""


def test_a_run_without_a_card_fails_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vgg_q.eval_realsense",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
