"""Exact int32 accumulation of int8 convolutions and transposed convolutions.

The counterpart of ``jax.lax.conv_general_dilated(..., preferred_element_type=
jnp.int32)`` on int8 operands, as ``QuantConv`` and ``QuantConvTranspose``
run it in their ``int8`` mode (``dream_tpu/models/quant.py:155-166``).  The
accumulator must be exact: products reach 127 * 127 and a 3x3 conv over 512
channels sums 4,608 of them, far past float32's exact 2**24, and a float32
cuDNN convolution may also pick a Winograd or FFT algorithm whose transforms
round.  The sums stay below 2**31 for every conv of the model zoo.

- :func:`conv2d_int32` and :func:`conv_transpose2d_int32`: the route the
  models run, on any device: an int8 GEMM (``torch._int_mm``, exact int32
  accumulation, cuBLASLt on the card) on im2col matrices built by slicing
  the zero-padded NHWC input once a tap.  The im2col is built a chunk of
  images, or of output rows within an image, at a time, so that one chunk's
  matrix stays under :data:`IM2COL_BUDGET` bytes.  The transposed conv is
  split into its ``stride**2`` phases (sub-pixel decomposition): output
  pixel ``(s*q + r)`` receives only the taps ``t = (r + p) mod s + s*j``,
  so each phase is a stride-1 conv of the undilated input with those taps,
  and no product with an inserted zero is computed.  Everything here is
  integer arithmetic and slicing, so ``torch.export`` traces it.
- :func:`conv2d_int32_plain` and :func:`conv_transpose2d_int32_plain`: the
  plain versions, a float64 convolution rounded back to integers (every
  partial sum is an integer below 2**53, and the rounding absorbs a
  transform-based algorithm's residue).

Activations are int8 NCHW ``[B, Ci, H, W]``; weights int8 in the torch
layouts, ``[Co, Ci, kh, kw]`` for a conv and ``[Ci, Co, kh, kw]`` for a
transposed conv; results int32 NCHW (a channels-last view).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

# Largest im2col chunk, in bytes: bounds the route's working memory (a
# vgg-F head conv at 400x400 holds 92 MB of im2col an image).
IM2COL_BUDGET = 256 * 2**20


def _check(x_q: torch.Tensor, w_q: torch.Tensor, in_dim: int) -> None:
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"activations and weights must be int8, got {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"expected 4-d activations and weights, got {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)}")
    if w_q.shape[in_dim] != x_q.shape[1]:
        raise ValueError(f"the weights take {w_q.shape[in_dim]} input channels, x_q has {x_q.shape[1]}")
    if x_q.device != w_q.device:
        raise ValueError(f"activations on {x_q.device}, weights on {w_q.device}")


def _int_mm(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ w_nk.T`` with exact int32 accumulation.  The operands are
    zero-padded to what cuBLASLt's int8 GEMM takes (K and N multiples of 8,
    M above 16); the padding adds exact zeros."""
    m, k = a.shape
    n = w_nk.shape[0]
    pad_k, pad_n, pad_m = -k % 8, -n % 8, max(0, 17 - m)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w_nk = F.pad(w_nk, (0, pad_k, 0, pad_n))
    return torch._int_mm(a.contiguous(), w_nk.contiguous().t())[:m, :n]


def _chunks(b: int, ho: int, row_bytes: int) -> Iterator[Tuple[int, int, int, int]]:
    """``(first image, end image, first row, end row)`` of each im2col chunk:
    whole images while an image fits the budget, else rows of one image."""
    rows = max(1, IM2COL_BUDGET // max(1, row_bytes))
    if rows >= ho:
        step = rows // ho
        for b0 in range(0, b, step):
            yield b0, min(b, b0 + step), 0, ho
        return
    for b0 in range(b):
        for r0 in range(0, ho, rows):
            yield b0, b0 + 1, r0, min(ho, r0 + rows)


def _correlate(xp: torch.Tensor, w_nk: torch.Tensor, kh: int, kw: int, stride: int,
               ho: int, wo: int) -> torch.Tensor:
    """Valid correlation of padded int8 NHWC ``xp`` with the taps of
    ``w_nk [Co, kh*kw*Ci]`` (tap-major, then channel), stride ``stride``:
    int32 NHWC ``[B, ho, wo, Co]``."""
    b, _, _, ci = xp.shape
    co = w_nk.shape[0]
    out = torch.empty((b, ho, wo, co), dtype=torch.int32, device=xp.device)
    s = stride
    for b0, b1, r0, r1 in _chunks(b, ho, wo * kh * kw * ci):
        cols = [xp[b0:b1, r0 * s + dy:(r1 - 1) * s + dy + 1:s, dx:(wo - 1) * s + dx + 1:s, :]
                for dy in range(kh) for dx in range(kw)]
        a = torch.cat(cols, dim=-1).reshape(-1, kh * kw * ci)
        out[b0:b1, r0:r1] = _int_mm(a, w_nk).reshape(b1 - b0, r1 - r0, wo, co)
    return out


def _nchw(acc_nhwc: torch.Tensor) -> torch.Tensor:
    return acc_nhwc.permute(0, 3, 1, 2)


def conv2d_int32(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """int8 ``x_q [B, Ci, H, W]`` * int8 ``w_q [Co, Ci, kh, kw]`` -> the
    exact int32 accumulator of ``F.conv2d(x, w, stride=stride,
    padding=padding)``, ``[B, Co, Ho, Wo]``."""
    _check(x_q, w_q, 1)
    co, ci, kh, kw = w_q.shape
    _, _, h, w = x_q.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    xp = F.pad(x_q.permute(0, 2, 3, 1), (0, 0, padding, padding, padding, padding))
    w_nk = w_q.permute(0, 2, 3, 1).reshape(co, kh * kw * ci)
    return _nchw(_correlate(xp, w_nk, kh, kw, stride, ho, wo))


def transposed_phases(k: int, stride: int, padding: int,
                      size_out: int) -> List[Tuple[int, List[int], int]]:
    """The phases of a transposed conv along one axis: for each output
    residue ``r`` (``o = stride*q + r``), the taps that reach it in
    correlation order and the input offset of the first: ``out[stride*q +
    r] = sum_j x[q + offset + j] * w[taps[j]]`` (``x`` zero outside)."""
    phases = []
    for r in range(min(stride, size_out)):
        first = (r + padding) % stride
        taps = list(range(first, k, stride))[::-1]
        # The last tap in correlation order is ``first``, at input q + c.
        c = (r + padding - first) // stride
        phases.append((r, taps, c - (len(taps) - 1)))
    return phases


def conv_transpose2d_int32(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 2,
                           padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """int8 ``x_q [B, Ci, H, W]`` * int8 ``w_q [Ci, Co, kh, kw]`` -> the
    exact int32 accumulator of ``F.conv_transpose2d(x, w, stride=stride,
    padding=padding, output_padding=output_padding)``, ``[B, Co, Ho, Wo]``,
    one stride-1 correlation per phase."""
    _check(x_q, w_q, 0)
    ci, co, kh, kw = w_q.shape
    b, _, h, w = x_q.shape
    ho = (h - 1) * stride - 2 * padding + kh + output_padding
    wo = (w - 1) * stride - 2 * padding + kw + output_padding
    x = x_q.permute(0, 2, 3, 1)
    out = torch.zeros((b, ho, wo, co), dtype=torch.int32, device=x_q.device)
    for ry, taps_y, oy in transposed_phases(kh, stride, padding, ho):
        for rx, taps_x, ox in transposed_phases(kw, stride, padding, wo):
            nqy, nqx = len(range(ry, ho, stride)), len(range(rx, wo, stride))
            if not taps_y or not taps_x:
                continue  # no tap reaches this phase: its sums are 0
            ny, nx = len(taps_y), len(taps_x)
            # Input rows oy .. oy + nqy + ny - 2 (and columns alike), zero
            # outside the image.
            lo_y, hi_y = max(0, -oy), max(0, oy + nqy + ny - 1 - h)
            lo_x, hi_x = max(0, -ox), max(0, ox + nqx + nx - 1 - w)
            xp = F.pad(x, (0, 0, lo_x, hi_x, lo_y, hi_y))
            xp = xp[:, oy + lo_y:oy + lo_y + nqy + ny - 1, ox + lo_x:ox + lo_x + nqx + nx - 1, :]
            w_sel = w_q[:, :, taps_y][:, :, :, taps_x]  # [Ci, Co, ny, nx]
            w_nk = w_sel.permute(1, 2, 3, 0).reshape(co, ny * nx * ci)
            out[:, ry::stride, rx::stride, :] = _correlate(xp, w_nk, ny, nx, 1, nqy, nqx)
    return _nchw(out)


def conv2d_int32_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                       padding: int = 0) -> torch.Tensor:
    """The plain version of :func:`conv2d_int32`: a float64 convolution."""
    _check(x_q, w_q, 1)
    acc = F.conv2d(x_q.to(torch.float64), w_q.to(torch.float64), stride=stride, padding=padding)
    return acc.round().to(torch.int32)


def conv_transpose2d_int32_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 2,
                                 padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """The plain version of :func:`conv_transpose2d_int32`: a float64
    transposed convolution."""
    _check(x_q, w_q, 0)
    acc = F.conv_transpose2d(x_q.to(torch.float64), w_q.to(torch.float64), stride=stride,
                             padding=padding, output_padding=output_padding)
    return acc.round().to(torch.int32)
