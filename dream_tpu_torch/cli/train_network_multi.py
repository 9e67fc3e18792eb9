"""Run N training instances one after another, for seed-variance studies.

The port of ``scripts/train_network_multi.py``: instance ``n`` runs
``python -m dream_tpu_torch.cli.train_network <train command> -o
<output dir>/train_<n>`` as a subprocess, and a failed instance stops the
run.

Example:
  python3 -m dream_tpu_torch.cli.train_network_multi -n 3 -o _scratch/multi \\
      -c "-i _scratch/d768 -m manip_configs/panda.yaml -ar arch_configs/dream_vgg_q.yaml -e 10 -b 32"
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

from dream_tpu_torch.utils.config import makedirs


def train_network_multi(args) -> list:
    """Run the instances; returns their output directories."""
    makedirs(args.output_dir, exist_ok=args.force_overwrite)
    # The instances import this package from wherever this process did.
    package_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (package_root, os.environ.get("PYTHONPATH")) if p))
    outputs = []
    for n in range(args.num_instances):
        output_dir = os.path.join(args.output_dir, f"train_{n}")
        cmd = ([sys.executable, "-m", "dream_tpu_torch.cli.train_network"]
               + shlex.split(args.train_command) + ["-o", output_dir])
        print(f"[train_network_multi] instance {n}: {shlex.join(cmd)}", flush=True)
        subprocess.run(cmd, check=True, env=env)
        outputs.append(output_dir)
    return outputs


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-n", "--num-instances", type=int, required=True)
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-c", "--train-command", required=True,
                        help="Command line options passed through to train_network.")
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    return parser


if __name__ == "__main__":
    train_network_multi(make_parser().parse_args())
