"""Cast a trained .msgpack checkpoint to float16 for committing to git.

The port of ``scripts/compress_checkpoint.py``: every float32 leaf of the
flax tree becomes float16 (other leaves stay), written with the port's
msgpack writer, and the ``.yaml`` sidecar beside the input (or the third
argument) is copied beside the output.  Loading widens the leaves back to
float32 in both packages (``DreamNetwork.load_network_params``), so the
file is a drop-in for every inference CLI.

Usage:
  python3 -m dream_tpu_torch.cli.compress_checkpoint in.msgpack out.msgpack [out.yaml]
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Any

import numpy as np

from dream_tpu_torch.checkpoint import load_flax_checkpoint, save_flax_checkpoint


def cast_float16(tree: Any) -> Any:
    """The tree with each float32 array leaf cast to float16."""
    if isinstance(tree, dict):
        return {key: cast_float16(value) for key, value in tree.items()}
    x = np.asarray(tree)
    return x.astype(np.float16) if x.dtype == np.float32 else x


def compress_checkpoint(src: str, dst: str, sidecar_dst: str = None) -> None:
    save_flax_checkpoint(dst, cast_float16(load_flax_checkpoint(src)))
    side_src = os.path.splitext(src)[0] + ".yaml"
    side_dst = sidecar_dst or os.path.splitext(dst)[0] + ".yaml"
    if os.path.exists(side_src):
        shutil.copyfile(side_src, side_dst)
    print(f"{src} ({os.path.getsize(src) / 1e6:.1f} MB) -> {dst} ({os.path.getsize(dst) / 1e6:.1f} MB)")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        raise SystemExit("usage: compress_checkpoint in.msgpack out.msgpack [out.yaml]")
    compress_checkpoint(*argv)


if __name__ == "__main__":
    main()
