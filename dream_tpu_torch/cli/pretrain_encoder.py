"""Pretrain the VGG19-layout encoder as a denoising autoencoder.

The port of ``scripts/pretrain_encoder.py``: the same flags and defaults
(plus ``--device``), on one device.  The pretext reconstructs the clean
image at a quarter of its resolution (a 4x4 mean pool) from a corrupted
copy: Gaussian noise of ``--noise-sigma``, a per-sample contrast in
[0.8, 1.2] and brightness in [-0.2, 0.2], and each channel of each sample
dropped with probability 0.1, under MSE and Adam at ``-lr``.  Scenes come
from :func:`dream_tpu_torch.data.synthetic.render_random_scene`: streamed,
a batch rendered on one host thread while the device trains on the last
(``scripts/pretrain_encoder.py:155-175``), or with ``--pool N`` rendered
once, kept on the device as uint8 and gathered there each step
(``:94-152``).  The corruption is drawn on the device from an explicit
generator (seeded ``-s`` + 1; the parameters are drawn from ``-s``), and
:func:`pretrain_step` takes those draws as arguments.  The output is
the encoder subtree (``down1`` .. ``down5``) as flax msgpack, which
``train_network --init-encoder`` grafts in either package.

Example:
  python3 -m dream_tpu_torch.cli.pretrain_encoder -o trained_models/encoder_ae.msgpack \\
      --steps 1500 --batch-size 32
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import time
from typing import Dict

import numpy as np
import torch

from dream_tpu_torch.checkpoint import save_flax_checkpoint, state_to_flax
from dream_tpu_torch.data.synthetic import render_random_scene
from dream_tpu_torch.models.pretrain import EncoderAutoencoder, extract_encoder_params
from dream_tpu_torch.network import resolve_device

DROP_RATE = 0.1


def draw_corruption(generator: torch.Generator, shape) -> Dict[str, torch.Tensor]:
    """The draws of one step's corruption for a ``[B, 3, H, W]`` batch, on
    the generator's device: standard normal ``noise`` of the batch's shape,
    ``brightness`` uniform in [-0.2, 0.2) and ``contrast`` in [0.8, 1.2)
    (``[B, 1, 1, 1]``), ``drop`` a boolean channel mask (``[B, 3, 1, 1]``,
    true with probability 0.1)."""
    b, c = shape[0], shape[1]
    device = generator.device

    def uniform(size, low, high):
        return torch.rand(size, generator=generator, device=device) * (high - low) + low

    return {"noise": torch.randn(shape, generator=generator, device=device),
            "brightness": uniform((b, 1, 1, 1), -0.2, 0.2),
            "contrast": uniform((b, 1, 1, 1), 0.8, 1.2),
            "drop": torch.rand((b, c, 1, 1), generator=generator, device=device) < DROP_RATE}


def corrupt(clean: torch.Tensor, draws: Dict[str, torch.Tensor], noise_sigma: float) -> torch.Tensor:
    """The noisy input (``scripts/pretrain_encoder.py:68-76``)."""
    noisy = clean + draws["noise"] * noise_sigma
    noisy = noisy * draws["contrast"] + draws["brightness"]
    return torch.where(draws["drop"], torch.zeros((), device=clean.device), noisy)


def pretrain_step(model: EncoderAutoencoder, optimizer: torch.optim.Optimizer,
                  clean_u8: torch.Tensor, draws: Dict[str, torch.Tensor],
                  noise_sigma: float) -> torch.Tensor:
    """One step on a uint8 ``[B, 3, H, W]`` batch given its corruption
    draws (``scripts/pretrain_encoder.py:65-87``): the clean image in [-1,
    1] (in the draws' dtype, float32 from :func:`draw_corruption`), its 4x4
    mean pool as the target, MSE, one Adam update.  Returns the loss (a 0-d
    tensor on the device)."""
    clean = clean_u8.to(draws["noise"].dtype) / 127.5 - 1.0
    target = torch.nn.functional.avg_pool2d(clean, 4)
    optimizer.zero_grad(set_to_none=True)
    loss = torch.mean((model(corrupt(clean, draws, noise_sigma)) - target) ** 2)
    loss.backward()
    optimizer.step()
    return loss.detach()


def render_batch(seed: int, batch_size: int, resolution) -> np.ndarray:
    """``batch_size`` scenes from ``RandomState(seed)``, ``[B, H, W, 3]`` uint8."""
    rng = np.random.RandomState(seed)
    return np.stack([render_random_scene(rng, resolution)[0] for _ in range(batch_size)])


def pretrain_encoder(args) -> dict:
    """Train and write the encoder; returns the per-step losses, the
    images/s of the training loop and the number of encoder parameters."""
    device = resolve_device(args.device)
    res = (args.resolution, args.resolution)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = EncoderAutoencoder(dtype=dtype, generator=torch.Generator().manual_seed(args.seed)).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.learning_rate)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    shape = (args.batch_size, 3, res[1], res[0])
    losses = []

    def log(i, t0):
        if (i + 1) % args.log_every == 0:
            recent = torch.stack(losses[-args.log_every:]).float().cpu().numpy()
            print(f"step {i + 1}/{args.steps}  recon mse {np.mean(recent):.5f}  "
                  f"({(i + 1) * args.batch_size / (time.time() - t0):.1f} imgs/s)", flush=True)

    def to_device(frames_u8):
        return torch.from_numpy(frames_u8).to(device).permute(0, 3, 1, 2)

    if args.pool:
        print(f"rendering {args.pool}-scene device pool ...", flush=True)
        pool_u8 = to_device(np.stack([render_random_scene(np.random.RandomState(args.seed + i), res)[0]
                                      for i in range(args.pool)]))
        print(f"pool resident ({pool_u8.numel() / 1e6:.0f} MB)", flush=True)
        t0 = time.time()
        for i in range(args.steps):
            idx = torch.randint(0, args.pool, (args.batch_size,), generator=generator, device=device)
            losses.append(pretrain_step(model, optimizer, pool_u8[idx], draw_corruption(generator, shape),
                                        args.noise_sigma))
            log(i, t0)
    else:
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(render_batch, args.seed, args.batch_size, res)
            t0 = time.time()
            for i in range(args.steps):
                clean = future.result()
                if i + 1 < args.steps:
                    future = pool.submit(render_batch, args.seed + i + 1, args.batch_size, res)
                losses.append(pretrain_step(model, optimizer, to_device(clean),
                                            draw_corruption(generator, shape), args.noise_sigma))
                log(i, t0)
    losses = torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0, np.float32)
    seconds = time.time() - t0

    encoder = extract_encoder_params(state_to_flax(model.state_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    save_flax_checkpoint(args.output, encoder)
    n = sum(leaf.size for block in encoder["params"].values() for conv in block.values()
            for leaf in conv.values())
    print(f"Wrote encoder ({n} params) to {args.output}")
    return {"losses": losses, "images_per_s": args.steps * args.batch_size / seconds if seconds else 0.0,
            "n_params": n}


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-o", "--output", required=True, help="Output encoder .msgpack path.")
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("-b", "--batch-size", type=int, default=32)
    parser.add_argument("-lr", "--learning-rate", type=float, default=2e-4)
    parser.add_argument("--resolution", type=int, default=256,
                        help="Square pretraining resolution (features transfer across resolutions).")
    parser.add_argument("--noise-sigma", type=float, default=0.25)
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--pool", type=int, default=0,
                        help="If >0, pre-render this many scenes once and keep them resident in "
                             "device memory; each step is then a device-side gather + fresh "
                             "on-device corruption (0 streams fresh scenes from the host every step).")
    parser.add_argument("-s", "--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    pretrain_encoder(make_parser().parse_args())
