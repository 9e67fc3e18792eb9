"""The two belief-map networks in plain PyTorch, float32, as published.

- ``vgg`` (DREAM-vgg-Q, NVlabs/DREAM ``dream/models.py`` ``DreamHourglass``
  with the upsample decoder): a VGG-19 encoder of five blocks (2, 2, 4, 4, 4
  3x3 convs with ReLU, 64-128-256-512-512 channels) with 2x2 floor max-pools
  between them; two decoder blocks of nearest x2, conv + ReLU, conv (no
  ReLU; 512-256-256, 256-128-64); the head 64-64-32-n_kp (ReLU between).
  Maps at a quarter of the input.
- ``resnet`` (DREAM-ResNet-H, ``ResnetSimple``): the ResNet-101 trunk
  (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max-pool, bottleneck layers of 3, 4,
  23, 3 blocks, stride on the 3x3 conv), four ConvTranspose(k4, s2, p1) +
  BatchNorm + ReLU blocks of 256 channels, and a 1x1 head with a bias.
  BatchNorm normalises with the batch's biased statistics in training and
  the running ones in evaluation, eps 1e-5.

Parameters are a flat dict named as the checkpoints name them (``down1.conv0.weight``,
``layer3.block7.bn2.running_var``, ``up0.deconv.weight``); conv weights OIHW,
transposed-conv weights ``[in, out, kh, kw]``.  :func:`parameter_spec` lists
them with their shapes and initial distributions.

``precision="fp8"`` is the control: every tensor the bf16 program stores in
bf16 (conv and transposed-conv inputs, weights and outputs, BatchNorm outputs,
residual sums) is rounded to float8 e4m3 and its gradient to e5m2, each scaled
per tensor by its largest magnitude, as fp8 training does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

VGG_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
RESNET_LAYERS = (3, 4, 23, 3)
BN_EPS = 1e-5


class Leaf(NamedTuple):
    name: str
    shape: tuple
    init: str  # "lecun" (normal, std 1/sqrt(fan_in)), "uniform" (+-1/sqrt(fan_in)), "zeros", "ones"
    fan_in: int
    trainable: bool


def _conv(spec: List[Leaf], name: str, cin: int, cout: int, k: int, bias: bool = True) -> None:
    spec.append(Leaf(f"{name}.weight", (cout, cin, k, k), "lecun", cin * k * k, True))
    if bias:
        spec.append(Leaf(f"{name}.bias", (cout,), "zeros", 0, True))


def _bn(spec: List[Leaf], name: str, c: int) -> None:
    spec += [Leaf(f"{name}.weight", (c,), "ones", 0, True), Leaf(f"{name}.bias", (c,), "zeros", 0, True),
             Leaf(f"{name}.running_mean", (c,), "zeros", 0, False),
             Leaf(f"{name}.running_var", (c,), "ones", 0, False)]


def parameter_spec(arch: str, n_keypoints: int, layers=RESNET_LAYERS) -> List[Leaf]:
    """Every parameter and buffer of the network, in module order."""
    spec: List[Leaf] = []
    if arch == "vgg":
        cin = 3
        for i, (c, n) in enumerate(VGG_BLOCKS):
            for j in range(n):
                _conv(spec, f"down{i + 1}.conv{j}", cin if j == 0 else c, c, 3)
            cin = c
        for name, (a, b, c) in (("upsample4", (512, 256, 256)), ("upsample3", (256, 128, 64))):
            _conv(spec, f"{name}.conv0", a, b, 3)
            _conv(spec, f"{name}.conv1", b, c, 3)
        _conv(spec, "head.conv0", 64, 64, 3)
        _conv(spec, "head.conv1", 64, 32, 3)
        _conv(spec, "head.conv2", 32, n_keypoints, 3)
        return spec
    if arch != "resnet":
        raise ValueError(f"unknown architecture {arch!r}")
    _conv(spec, "conv1", 3, 64, 7, bias=False)
    _bn(spec, "bn1", 64)
    cin = 64
    for i, (features, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        for b in range(n_blocks):
            p = f"layer{i + 1}.block{b}"
            _conv(spec, f"{p}.conv1", cin, features, 1, bias=False)
            _bn(spec, f"{p}.bn1", features)
            _conv(spec, f"{p}.conv2", features, features, 3, bias=False)
            _bn(spec, f"{p}.bn2", features)
            _conv(spec, f"{p}.conv3", features, features * 4, 1, bias=False)
            _bn(spec, f"{p}.bn3", features * 4)
            if b == 0:
                _conv(spec, f"{p}.downsample_conv", cin, features * 4, 1, bias=False)
                _bn(spec, f"{p}.downsample_bn", features * 4)
            cin = features * 4
    for i in range(4):
        spec.append(Leaf(f"up{i}.deconv.weight", (cin, 256, 4, 4), "uniform", cin * 16, True))
        spec.append(Leaf(f"up{i}.deconv.bias", (256,), "zeros", 0, True))
        _bn(spec, f"up{i}.bn", 256)
        cin = 256
    _conv(spec, "head", 256, n_keypoints, 1)
    return spec


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 at a per-tensor scale; the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class Net:
    """A functional network over a parameter dict."""

    def __init__(self, arch: str, params: Dict[str, torch.Tensor], precision: str = "float32",
                 layers=RESNET_LAYERS):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.arch, self.p, self.precision, self.layers = arch, params, precision, tuple(layers)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.precision == "fp8" else x

    def conv(self, x, name, stride=1, padding=None, bias=True):
        w = self.p[f"{name}.weight"]
        pad = w.shape[-1] // 2 if padding is None else padding
        b = self.p.get(f"{name}.bias") if bias else None
        return self._q(F.conv2d(self._q(x), self._q(w), b, stride=stride, padding=pad))

    def deconv(self, x, name):
        return self._q(F.conv_transpose2d(self._q(x), self._q(self.p[f"{name}.weight"]),
                                          self.p[f"{name}.bias"], stride=2, padding=1))

    def bn(self, x, name, train):
        p = self.p
        return self._q(F.batch_norm(x, p[f"{name}.running_mean"].clone(), p[f"{name}.running_var"].clone(),
                                    p[f"{name}.weight"], p[f"{name}.bias"], training=train, momentum=0.0,
                                    eps=BN_EPS))

    def __call__(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NCHW float32 input -> NCHW float32 belief maps."""
        return self._vgg(x) if self.arch == "vgg" else self._resnet(x, train)

    def _vgg(self, x):
        for i, (_, n) in enumerate(VGG_BLOCKS):
            if i:
                x = F.max_pool2d(x, 2, 2)
            for j in range(n):
                x = F.relu(self.conv(x, f"down{i + 1}.conv{j}"))
        for name in ("upsample4", "upsample3"):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.conv(F.relu(self.conv(x, f"{name}.conv0")), f"{name}.conv1")
        x = F.relu(self.conv(x, "head.conv0"))
        x = F.relu(self.conv(x, "head.conv1"))
        return self.conv(x, "head.conv2")

    def _resnet(self, x, train):
        x = F.relu(self.bn(self.conv(x, "conv1", stride=2, padding=3, bias=False), "bn1", train))
        x = F.max_pool2d(x, 3, 2, 1)
        for i, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                p = f"layer{i + 1}.block{b}"
                stride = 2 if (b == 0 and i > 0) else 1
                out = F.relu(self.bn(self.conv(x, f"{p}.conv1", bias=False), f"{p}.bn1", train))
                out = F.relu(self.bn(self.conv(out, f"{p}.conv2", stride=stride, bias=False),
                                     f"{p}.bn2", train))
                out = self.bn(self.conv(out, f"{p}.conv3", bias=False), f"{p}.bn3", train)
                if b == 0:
                    x = self.bn(self.conv(x, f"{p}.downsample_conv", stride=stride, bias=False),
                                f"{p}.downsample_bn", train)
                x = F.relu(self._q(out + x))
        for i in range(4):
            x = F.relu(self.bn(self.deconv(x, f"up{i}.deconv"), f"up{i}.bn", train))
        return self.conv(x, "head")


def output_resolution(arch: str, net_input_resolution) -> tuple:
    """(width, height) of the maps for a (width, height) input."""
    w, h = net_input_resolution
    if arch == "vgg":
        return (w // 16 * 4, h // 16 * 4)
    for _ in range(5):
        w, h = (w - 1) // 2 + 1, (h - 1) // 2 + 1
    return (w * 16, h * 16)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 convolutions and matmuls while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
