"""The training step in plain PyTorch, float32: the batch processor, the
weighted MSE, Adam with global-norm clipping, the cosine schedule and the
parameter EMA (NVlabs/DREAM ``dream/network.py``, ``dream/image_proc.py`` and
the albumentations transforms its ``dream/datasets.py`` applies).

Batch processor, for raw uint8 ``[B, H, W, 3]`` frames and raw-frame keypoints:

1. shrink-and-crop: the centred crop of the net input's aspect, resized by an
   antialiased bilinear operator (a triangle filter widened by the
   downscale factor, one dense matrix an axis), float32 on the 0-255 scale;
2. augmentation, each with probability 1/2 an image: ShiftScaleRotate (an
   inverse affine warp, bilinear taps, reflect-101 borders; rotation within
   15 degrees, scale within 10%, shift within 6.25%), brightness and contrast
   within 20% (brightness relative to the image's mean), Gaussian noise of
   variance 10-50; clipped to 0-255.  The draws come, in a fixed order, from
   the generator handed in, so that one seed gives one batch;
3. ``(x / 255 - 0.5) / 0.5`` normalisation;
4. belief-map targets at the net output: a sigma-2 Gaussian in a 9x9 window
   at each keypoint's truncated pixel, all zero unless the window lies inside.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` antialiased bilinear resize operator, float32."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], weights, f32(0.0)).astype(f32).T)


def crop_box(raw_res, net_res) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((crop width, height), (left, top)) of shrink-and-crop."""
    in_w, in_h = raw_res
    ref_w, ref_h = net_res
    ref_h_by_w = int(float(in_w) / float(ref_w) * ref_h)
    ref_w_by_h = int(float(in_h) / float(ref_h) * ref_w)
    size = (ref_w_by_h, in_h) if in_w >= ref_w_by_h else (in_w, ref_h_by_w)
    return size, ((in_w - size[0]) // 2, (in_h - size[1]) // 2)


def netin_from_raw(kp: torch.Tensor, raw_res, net_res) -> torch.Tensor:
    """Raw-frame keypoints -> net-input frame (shrink-and-crop), per axis."""
    (cw, ch), (cx, cy) = crop_box(raw_res, net_res)
    scale = (float(net_res[0]) / float(cw), float(net_res[1]) / float(ch))
    offset = (scale[0] * -float(cx), scale[1] * -float(cy))
    return torch.stack([kp[..., i] * scale[i] + offset[i] for i in (0, 1)], dim=-1)


def scale_keypoints(kp: torch.Tensor, src_res, dst_res) -> torch.Tensor:
    s = (float(dst_res[0]) / float(src_res[0]), float(dst_res[1]) / float(src_res[1]))
    return torch.stack([kp[..., i] * s[i] + 0.0 for i in (0, 1)], dim=-1)


def preprocess(images_u8: torch.Tensor, net_res) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float32 ``[B, h, w, 3]`` on the 0-255 scale."""
    raw_res = (images_u8.shape[2], images_u8.shape[1])
    (cw, ch), (cx, cy) = crop_box(raw_res, net_res)
    x = images_u8[:, cy:cy + ch, cx:cx + cw, :].to(torch.float32).permute(0, 3, 1, 2)
    dev = x.device
    if ch != net_res[1]:
        x = torch.matmul(torch.from_numpy(resize_matrix(ch, net_res[1])).to(dev), x)
    if cw != net_res[0]:
        x = torch.matmul(x, torch.from_numpy(resize_matrix(cw, net_res[0])).to(dev).T)
    return x.permute(0, 2, 3, 1)


def normalize(x: torch.Tensor, mean: Sequence[float], stdev: Sequence[float]) -> torch.Tensor:
    m = torch.tensor(list(mean), dtype=torch.float32, device=x.device)
    s = torch.tensor(list(stdev), dtype=torch.float32, device=x.device)
    return (x / 255.0 - m) / s


def _rand(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=g, device=g.device)


def augment(g: torch.Generator, images: torch.Tensor, kp: torch.Tensor):
    """Draw one batch's augmentation from ``g`` and apply it to 0-255 float
    images ``[B, h, w, 3]`` and their net-input keypoints ``[B, n, 2]``."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]

    def uniform(lo, hi):
        return lo + (hi - lo) * _rand(g, n)

    warp_on = _rand(g, n) < 0.5
    angle = uniform(-15.0, 15.0)
    scale = 1.0 + uniform(-0.1, 0.1)
    dx = uniform(-0.0625, 0.0625) * w
    dy = uniform(-0.0625, 0.0625) * h
    bc_on = _rand(g, n) < 0.5
    alpha = 1.0 + uniform(-0.2, 0.2)
    beta = uniform(-0.2, 0.2)
    noise_on = _rand(g, n) < 0.5
    noise_var = uniform(10.0, 50.0)
    noise = torch.randn((n,) + tuple(images.shape[1:]), generator=g, device=images.device)

    angle = torch.where(warp_on, angle * (math.pi / 180.0), torch.zeros_like(angle))
    scale = torch.where(warp_on, scale, torch.ones_like(scale))
    dx = torch.where(warp_on, dx, torch.zeros_like(dx))
    dy = torch.where(warp_on, dy, torch.zeros_like(dy))
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(angle) * scale, torch.sin(angle) * scale
    affine = torch.stack([torch.stack([cos, sin, (1 - cos) * cx - sin * cy + dx], -1),
                          torch.stack([-sin, cos, sin * cx + (1 - cos) * cy + dy], -1)], -2)

    out = warp(images, affine)
    ones = torch.ones(kp.shape[:-1] + (1,), dtype=kp.dtype, device=kp.device)
    kp = torch.cat([kp, ones], -1) @ affine.transpose(-1, -2)

    def per_image(v):
        return v[:, None, None, None]

    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.where(per_image(bc_on), out * per_image(alpha) + per_image(beta) * mean, out)
    out = torch.where(per_image(noise_on), out + noise * torch.sqrt(per_image(noise_var)), out)
    return out.clamp(0.0, 255.0), kp


def _reflect101(x: torch.Tensor, n: int) -> torch.Tensor:
    m = 2.0 * (n - 1)
    x = torch.remainder(x, m).abs()
    return torch.where(x > (n - 1), m - x, x)


def warp(images: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Each output pixel samples the image at the inverse affine's point,
    bilinear taps, reflect-101 borders."""
    b, h, w, c = images.shape
    full = torch.cat([affine, torch.tensor([[[0.0, 0.0, 1.0]]], device=affine.device).expand(b, 1, 3)], 1)
    inv = torch.linalg.inv(full)[:, :2, :].reshape(b, 6)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                            torch.arange(w, dtype=torch.float32, device=images.device), indexing="ij")
    i = inv[:, :, None, None]
    sx = _reflect101(i[:, 0] * xs + i[:, 1] * ys + i[:, 2], w)
    sy = _reflect101(i[:, 3] * xs + i[:, 4] * ys + i[:, 5], h)
    x0 = torch.floor(sx).long().clamp(0, w - 2)
    y0 = torch.floor(sy).long().clamp(0, h - 2)
    tx = (sx - x0.float()).clamp(0.0, 1.0)[..., None]
    ty = (sy - y0.float()).clamp(0.0, 1.0)[..., None]
    idx = torch.arange(b, device=images.device)[:, None, None]

    def tap(dy, dx):
        return images[idx, y0 + dy, x0 + dx]

    return (tap(0, 0) * (1 - tx) * (1 - ty) + tap(0, 1) * tx * (1 - ty)
            + tap(1, 0) * (1 - tx) * ty + tap(1, 1) * tx * ty)


def belief_maps(kp: torch.Tensor, res, sigma: float = 2.0) -> torch.Tensor:
    """``[B, n, 2]`` net-output keypoints -> ``[B, n, h, w]`` targets."""
    width, height = int(res[0]), int(res[1])
    r = int(sigma * 2)
    pixel = torch.trunc(kp).long()
    pu, pv = pixel[..., 0, None, None], pixel[..., 1, None, None]
    inside = (pu - r >= 0) & (pu + r + 1 < width) & (pv - r >= 0) & (pv + r + 1 < height)
    dx = (torch.arange(width, device=kp.device) - pu).float()
    dy = (torch.arange(height, device=kp.device)[:, None] - pv).float()
    g = torch.exp(-(dy ** 2 + dx ** 2) / (2.0 * sigma ** 2))
    return torch.where(inside & (dy.abs() <= r) & (dx.abs() <= r), g, torch.zeros((), device=kp.device))


def weighted_mse(pred: torch.Tensor, target: torch.Tensor, pos_weight: float) -> torch.Tensor:
    """``sum(w (pred - target)^2) / sum(w)``, ``w = 1 + (pos_weight - 1) clip(target, 0, 1)``."""
    w = 1.0 + (pos_weight - 1.0) * target.clamp(0.0, 1.0)
    return torch.sum(w * (pred - target) ** 2) / torch.sum(w)


def cosine_lr(step: int, peak: float, decay_steps: int) -> float:
    """The learning rate of the ``step``-th update (0-based): a cosine from
    ``peak`` to 0 over ``decay_steps``."""
    return peak * 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))


class Trainer:
    """Adam (beta 0.9, 0.999, eps 1e-8) on the clipped gradient, the cosine
    schedule, and an EMA of the parameters, over a parameter dict."""

    def __init__(self, net, trainable: List[str], recipe: Dict, net_res, out_res, raw_res,
                 normalization: Dict, pos_weight: float):
        self.net, self.names, self.recipe = net, trainable, recipe
        self.net_res, self.out_res, self.raw_res = tuple(net_res), tuple(out_res), tuple(raw_res)
        self.norm, self.pos_weight = normalization, pos_weight
        params = net.p
        self.m = {k: torch.zeros_like(params[k]) for k in trainable}
        self.v = {k: torch.zeros_like(params[k]) for k in trainable}
        decay = recipe.get("ema_decay")
        self.ema = {k: params[k].clone() for k in trainable} if decay else None
        self.t = 0

    def batch(self, g: torch.Generator, images_u8: torch.Tensor, kp_raw: torch.Tensor):
        x = preprocess(images_u8, self.net_res)
        kp = netin_from_raw(kp_raw.float(), self.raw_res, self.net_res)
        x, kp = augment(g, x, kp)
        x = normalize(x, self.norm["mean"], self.norm["stdev"])
        target = belief_maps(scale_keypoints(kp, self.net_res, self.out_res), self.out_res)
        return x, target

    def step(self, g: torch.Generator, images_u8: torch.Tensor, kp_raw: torch.Tensor):
        """One update; returns (loss before it, {leaf: clipped gradient})."""
        x, target = self.batch(g, images_u8, kp_raw)
        params = self.net.p
        dtype = params[self.names[0]].dtype  # float64 for a double-precision witness
        x, target = x.to(dtype), target.to(dtype)
        for k in self.names:
            params[k].requires_grad_(True)
        pred = self.net(x.permute(0, 3, 1, 2), train=True)
        loss = weighted_mse(pred, target, self.pos_weight)
        grads = torch.autograd.grad(loss, [params[k] for k in self.names])
        norm = torch.sqrt(sum(torch.sum(gr * gr) for gr in grads))
        clip = self.recipe["grad_clip_norm"]
        if float(norm) >= clip:
            grads = [gr / norm * clip for gr in grads]
        lr = cosine_lr(self.t, self.recipe["learning_rate"], self.recipe["decay_steps"])
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for k, gr in zip(self.names, grads):
                p = params[k]
                p.requires_grad_(False)
                self.m[k].mul_(b1).add_(gr, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
                if self.ema is not None:
                    d = self.recipe["ema_decay"]
                    self.ema[k].copy_(self.ema[k] * d + p * (1.0 - d))
        return float(loss.detach()), dict(zip(self.names, grads))
