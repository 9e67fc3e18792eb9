"""DreamNetwork: the config-driven facade of the port, inference and training.

Port of ``dream_tpu/network.py``: build the model a self-describing YAML
config names (``:197-264``: the vgg hourglasses, single- or multistage, and
ResNet-H/F), load and save flax msgpack weights with their YAML sidecar,
run ``image -> (belief_maps, keypoints)`` on one device, and train: the
belief-map criteria (``:70-118``), the multistage loss (``:373-392``), the
optimizer with its schedule and global-norm clipping (``:394-435``), the
train steps with BatchNorm's running statistics (``:437-460``), the EMA
(``:512-532``), the scanned epoch over a set held on the device
(``enable_scanned_training``, ``:582-657``: one CUDA graph of the step,
replayed for each step) and the evaluation loss; quantization-aware training of the
vgg hourglasses (``quant_mode: qat``) and int8 inference of every
architecture (``enable_int8_inference``, ``:796-969``: vgg-Q's chain of
int8 conv kernels, or the quantized conv graph of any hourglass and of the
ResNets' BatchNorm-folded deploy graph); the soft-argmax head
(``spatial_softmax``, ``:201-210``), which decodes its own keypoints;
the decode's peak scores
for the robust PnP modes (``inference_detailed``, ``:984-1028``); and
warm starts from a pretrained encoder (``init_encoder_from``,
``:1116-1145``) and, across packages, from an optax optimizer state
(``optimizer_state``, ``load_optimizer_state``).  The model computes in the
config's ``compute_dtype``, float32 or bfloat16, with float32 parameters,
as the JAX package does.
Peak decoding runs in the CUDA score kernel, the augmentation's warp in
the CUDA warp kernel and the int8 chain's convs in the CUDA int8 conv
kernel for CUDA tensors, and in their plain torch versions for CPU
tensors, chosen by the tensor's device.

Training runs on one device or, after ``shard_for_mesh`` (``:471-510``),
on a ``(data, model)`` mesh of ranks (:mod:`dream_tpu_torch.parallel`):
each rank steps on its rows of the global batch, with the loss, gradients
and BatchNorm statistics of the whole batch, and the wide convs split over
the model axis.  The multistage cascade can run its inference as a GPipe
pipeline over devices (``enable_pipeline_inference``, ``:750-798``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of falling back.
"""

from __future__ import annotations

import copy
import functools
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dream_tpu_torch.checkpoint import (
    load_flax_checkpoint,
    optimizer_state_from_flax,
    optimizer_state_to_flax,
    params_from_flax,
    save_flax_checkpoint,
    state_from_flax,
    state_to_flax,
)
from dream_tpu_torch.models import (
    DreamHourglass,
    DreamHourglassMultiStage,
    ResnetSimple,
    ResnetSimpleDeploy,
    fold_batchnorm_resnet,
)
from dream_tpu_torch.models import quant as quant_ops
from dream_tpu_torch.models.layers import BatchNorm2d
from dream_tpu_torch.models import vgg_int8_deploy
from dream_tpu_torch.models.pretrain import graft_encoder_params
from dream_tpu_torch.ops import belief_maps as bm_ops
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import image_proc as image_proc_ops
from dream_tpu_torch.ops.warp import warp_batch_kernel
from dream_tpu_torch.parallel import mesh as mesh_ops
from dream_tpu_torch.utils import resolutions as res_utils
from dream_tpu_torch.utils.config import load_yaml, save_yaml

KNOWN_OPTIMIZERS = ["adam", "sgd"]  # reference dream/network.py:23-26
KNOWN_ARCHITECTURES = ["vgg", "resnet"]
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The int8 graphs DREAM_INT8_IMPL names (dream_tpu/network.py:857-906):
# "xla_chain" and "pallas" both name vgg-Q's chain of int8 conv kernels,
# "quantconv" the quantized conv graph of any architecture.
INT8_IMPLS = ("auto", "xla_chain", "quantconv", "pallas")


def int8_impl_from_env() -> str:
    """``DREAM_INT8_IMPL`` (default ``auto``), validated as ``dream_tpu``
    does."""
    impl = os.environ.get("DREAM_INT8_IMPL", "auto")
    if impl not in INT8_IMPLS:
        raise ValueError(f"DREAM_INT8_IMPL={impl!r}: expected one of {', '.join(map(repr, INT8_IMPLS))}.")
    return impl


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``, as configs name dtypes."""
    return str(dtype).removeprefix("torch.")


def resolve_device(device: Any) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must be available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def create_network_from_config_file(
    config_file_path: str, network_params_path: Optional[str] = None,
    device: Any = "cuda",
) -> "DreamNetwork":
    """Parity: ``dream_tpu.network.create_network_from_config_file``.  With
    ``network_params_path`` no initial parameters are drawn: the checkpoint
    gives them all."""
    if not os.path.exists(config_file_path):
        raise FileNotFoundError(config_file_path)
    if network_params_path and not os.path.exists(network_params_path):
        raise FileNotFoundError(network_params_path)
    if network_params_path:
        return DreamNetwork.from_checkpoint(load_yaml(config_file_path), network_params_path, device)
    return DreamNetwork(load_yaml(config_file_path), device=device)


def create_network_from_config_data(network_config_data: Dict[str, Any],
                                    device: Any = "cuda") -> "DreamNetwork":
    """Parity: ``dream_tpu.network.create_network_from_config_data``: the
    network a loaded config dict describes, with its initial parameters."""
    return DreamNetwork(network_config_data, device=device)


def _count(pred: torch.Tensor) -> torch.Tensor:
    """The number of elements of ``pred``, as a 0-d tensor on its device
    (filled there: no host-to-device copy)."""
    return pred.new_full((), float(pred.numel()), dtype=torch.float32)


def _mse_terms(pred: torch.Tensor, target: torch.Tensor):
    return torch.sum((pred - target) ** 2), _count(pred)


def _huber_terms(pred: torch.Tensor, target: torch.Tensor):
    d = torch.abs(pred - target)
    return torch.sum(torch.where(d < 1.0, 0.5 * d * d, d - 0.5)), _count(pred)


def _weighted_mse_terms(pos_weight: float, symmetric: bool = False) -> Callable:
    """The weighted MSE's (numerator, denominator): ``sum(w * d^2)`` and
    ``sum(w)``, the weights taking no gradient."""

    def terms(pred: torch.Tensor, target: torch.Tensor):
        t = torch.clamp(target, 0.0, 1.0)
        if symmetric:
            p = torch.clamp(pred.detach().to(torch.float32), 0.0, 1.0)
            t = torch.maximum(t, p)
        w = 1.0 + (pos_weight - 1.0) * t
        return torch.sum(w * (pred - target) ** 2), torch.sum(w).detach()

    return terms


def _ratio(terms: Callable) -> Callable:
    def criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        num, den = terms(pred, target)
        return num / den

    return criterion


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return _ratio(_mse_terms)(pred, target)


def huber_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch SmoothL1Loss (beta=1) semantics."""
    return _ratio(_huber_terms)(pred, target)


def weighted_mse_loss(pos_weight: float, symmetric: bool = False) -> Callable:
    """MSE with pixel weights ``1 + (pos_weight - 1) * t``, normalised by
    their sum, where ``t`` is the target clipped to [0, 1] or, when
    ``symmetric``, ``max(t, clip(pred, 0, 1))`` with no gradient through the
    prediction's weight (``dream_tpu/network.py:78-118``)."""
    return _ratio(_weighted_mse_terms(pos_weight, symmetric))


def loss_terms_from_config(loss_config: Optional[Dict[str, Any]]) -> Callable:
    """``terms(pred, target) -> (numerator, denominator)`` of the criterion
    ``architecture.loss`` names (mse when None): the criterion is their
    ratio, and their sums over any split of the batch give it whole (the
    weighted MSE's normaliser is the sum of its weights, not a mean of
    per-part ratios, ``dream_tpu/parallel/pipeline.py:121-150``).  The
    denominator takes no gradient."""
    loss_type = loss_config["type"] if loss_config else "mse"
    if loss_type == "mse":
        return _mse_terms
    if loss_type == "huber":
        return _huber_terms
    if loss_type == "weighted_mse":
        return _weighted_mse_terms(float(loss_config.get("pos_weight", 100.0)),
                                   bool(loss_config.get("symmetric", False)))
    raise NotImplementedError(f'Loss "{loss_type}" not yet implemented.')


def criterion_from_config(loss_config: Dict[str, Any]) -> Callable:
    """The criterion named by ``architecture.loss`` (``network.py:299-309``):
    the ratio of :func:`loss_terms_from_config`'s terms."""
    named = {"mse": mse_loss, "huber": huber_loss}
    return named.get(loss_config["type"]) or _ratio(loss_terms_from_config(loss_config))


def warmup_cosine_decay(step: int, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, peak_value, warmup_steps,
    decay_steps, end_value)`` at ``step``, as ``dream_tpu`` builds it: a
    linear warmup from 0 over ``warmup_steps``, then a cosine from
    ``peak_value`` to ``end_value`` over the remaining ``decay_steps -
    warmup_steps``."""
    if step < warmup_steps:
        return peak_value * max(step, 0) / warmup_steps
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    count = min(step - warmup_steps, decay_steps - warmup_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * count / (decay_steps - warmup_steps)))
    return peak_value * ((1 - alpha) * cosine + alpha)


def warmup_cosine_decay_device(count: torch.Tensor, peak_value: float, warmup_steps: int,
                               decay_steps: int, end_value: float = 0.0) -> torch.Tensor:
    """:func:`warmup_cosine_decay` at the integer step tensor ``count``, a
    float32 0-d tensor on its device computed as optax computes it: float32
    throughout, ``join_schedules`` of ``linear_schedule`` (a clip of the
    count, ``1 - count / warmup``) and ``cosine_decay_schedule`` (the count
    capped at ``decay_steps - warmup_steps``).  No host sync, so a CUDA
    graph holds it."""
    f32 = torch.float32
    if warmup_steps > 0:
        frac = 1 - count.clamp(0, warmup_steps).to(f32) / warmup_steps
        warm = (0.0 - peak_value) * frac + peak_value
    else:
        warm = torch.zeros((), dtype=f32, device=count.device)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = float(decay_steps - warmup_steps)
    decayed = torch.clamp_max((count - warmup_steps).to(f32), span)
    cosine = 0.5 * (1 + torch.cos(math.pi * decayed / span))
    return torch.where(count < warmup_steps, warm, peak_value * ((1 - alpha) * cosine + alpha))


class DeviceSGD(torch.optim.SGD):
    """Plain SGD (``p - lr * g``, optax's ``sgd``) whose learning rate is a
    0-d tensor on the parameters' device, read there: ``torch.optim.SGD``
    takes a tensor learning rate to the host, which a CUDA graph cannot
    hold."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                torch._foreach_sub_(params, torch._foreach_mul([p.grad for p in params], group["lr"]))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         split: Optional[Sequence[bool]] = None, mesh=None) -> torch.Tensor:
    """Clip in place as ``optax.clip_by_global_norm``: with ``norm`` the
    global L2 norm, every ``g`` becomes ``(g / norm) * max_norm`` when
    ``norm >= max_norm`` and stays otherwise (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead).  Selected on the device, with no host sync;
    returns the norm.  Where ``split`` marks the gradients of channel-split
    parameters, their squares are summed over ``mesh``'s model group
    first: each rank holds a part of them."""
    if split is not None and any(split):
        from dream_tpu_torch.parallel.mesh import sum_over_model_group

        pieces = sum(torch.sum(g * g) for g, s in zip(grads, split) if s)
        whole = sum(torch.sum(g * g) for g, s in zip(grads, split) if not s)
        norm = torch.sqrt(whole + sum_over_model_group(pieces, mesh))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclass
class _EpochGraph:
    """A CUDA graph of one scanned step: its static index tensor and loss,
    the warp launches one replay makes, the key it was captured for and the
    tensors whose addresses that key holds."""

    graph: torch.cuda.CUDAGraph
    row: torch.Tensor
    loss: torch.Tensor
    warp_launches: int
    key: tuple
    inputs: tuple


class DreamNetwork:
    """Config-validated model + decode + coordinate maps + training.

    The model starts from flax's initial values drawn from ``seed``, or from
    a checkpoint's (:meth:`from_checkpoint`)."""

    def __init__(self, network_config: Dict[str, Any], device: Any = "cuda", seed: int = 0):
        self.device = resolve_device(device)
        for key in ("architecture", "manipulator", "training"):
            if key not in network_config:
                raise ValueError(f'Required key "{key}" is missing from network configuration.')
        arch = network_config["architecture"]
        manip = network_config["manipulator"]
        self.network_config = network_config
        self.manipulator_name = manip["name"]
        self.keypoint_names: List[str] = [kp["name"] for kp in manip["keypoints"]]
        self.friendly_keypoint_names: List[str] = [
            kp.get("friendly_name", kp["name"]) for kp in manip["keypoints"]
        ]
        self.n_keypoints = len(self.keypoint_names)
        self.architecture_type = arch["type"]
        if self.architecture_type not in KNOWN_ARCHITECTURES:
            raise ValueError(f'Architecture type "{self.architecture_type}" is not recognized.')
        self.image_normalization = arch["image_normalization"]
        if self.image_preprocessing() not in res_utils.KNOWN_IMAGE_PREPROC_TYPES:
            raise ValueError(f'Image preprocessing type "{self.image_preprocessing()}" is not recognized.')
        if arch["input_heads"][0] != "image_rgb":
            raise ValueError('First input head must be "image_rgb".')
        # The soft-argmax head: the model emits keypoints beside its maps
        # (dream_tpu/network.py:201-210).
        self.soft_argmax_head = "spatial_softmax" in arch
        expected_heads = ["belief_maps", "keypoints"] if self.soft_argmax_head else ["belief_maps"]
        if arch["output_heads"] != expected_heads:
            raise ValueError(f"output_heads must be {expected_heads} for this architecture, "
                             f"got {arch['output_heads']}")
        if self.soft_argmax_head and (arch["type"] != "vgg" or "n_stages" in arch):
            raise NotImplementedError(
                "the soft-argmax head is built for the single-stage vgg hourglass; the multistage "
                "model passes its stages' maps alone on, so no keypoints reach its output"
            )
        # QAT fake-quantizes the training graph; calibrate/int8 are driven by
        # enable_int8_inference (dream_tpu/network.py:190-200).
        self.quant_mode = arch.get("quant_mode")
        if self.quant_mode not in (None, "qat"):
            raise NotImplementedError(
                f'architecture "quant_mode" must be null or "qat", got {self.quant_mode!r}'
            )
        # The dtype the model computes in; parameters stay float32.
        self.compute_dtype = COMPUTE_DTYPES[arch.get("compute_dtype", "float32")]

        # Multi-peak disambiguation knobs (reference dream/network.py:187-191).
        self.use_belief_peak_scores = True
        self.belief_peak_next_best_score = 0.25

        self._seed = seed
        generator = torch.Generator().manual_seed(seed)
        if self.architecture_type == "vgg":
            # The reference's exact rules (dream_tpu/network.py:218-224).
            vgg_kwargs: Dict[str, Any] = {}
            if "deconv_decoder" in arch and "full_output" not in arch:
                vgg_kwargs["deconv_decoder"] = arch["deconv_decoder"]
            elif "full_output" in arch:
                vgg_kwargs["deconv_decoder"] = arch["deconv_decoder"]
                vgg_kwargs["full_output"] = True
            if "skip_connections" in arch:
                vgg_kwargs["skip_connections"] = arch["skip_connections"]
            if self.soft_argmax_head:
                vgg_kwargs.update(internalize_spatial_softmax=True,
                                  learned_beta=arch["spatial_softmax"]["learned_beta"],
                                  initial_beta=arch["spatial_softmax"]["initial_beta"])
            common = dict(generator=generator, quant_mode=self.quant_mode,
                          dtype=self.compute_dtype, **vgg_kwargs)
            if "n_stages" in arch:
                model = DreamHourglassMultiStage(self.n_keypoints, arch["n_stages"], **common)
            else:
                model = DreamHourglass(self.n_keypoints, **common)
            self._arch_kwargs = {"deconv_decoder": vgg_kwargs.get("deconv_decoder", False),
                                 "full_output": vgg_kwargs.get("full_output", False)}
        else:
            if self.quant_mode is not None:
                raise ValueError(
                    "QAT applies to vgg architectures; a resnet is quantized post hoc "
                    "on its BatchNorm-folded graph (dream_tpu/network.py:239-251)"
                )
            resnet_kwargs: Dict[str, Any] = {}
            if "full_decoder" in arch:
                resnet_kwargs["full"] = arch["full_decoder"]
            if "layers" in arch:
                resnet_kwargs["layers"] = tuple(arch["layers"])
            model = ResnetSimple(self.n_keypoints, dtype=self.compute_dtype, generator=generator,
                                 **resnet_kwargs)
            self._arch_kwargs = {"full": resnet_kwargs.get("full", False)}
        self.model = model.to(self.device).eval()
        self.criterion = criterion_from_config(arch["loss"])
        self._loss_terms = loss_terms_from_config(arch["loss"])
        self.optimizer: Optional[torch.optim.Optimizer] = None
        # The learning rate's schedule, a function of the step count tensor.
        self._schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self.steps = 0  # optimizer steps taken, optax's ``count``
        # ``steps`` on the device too (int32, as optax's count), which each
        # step moves there: a CUDA graph of the step moves it.
        self._count: Optional[torch.Tensor] = None
        # enable_scanned_training's flag, and the CUDA graph of its step.
        self._scanning = False
        self._epoch_graph: Optional[_EpochGraph] = None
        self._clip_norm: Optional[float] = None
        self._batch_processor: Optional[Callable] = None
        self.ema_decay: Optional[float] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        # The int8 graph enable_int8_inference selected: vgg-Q's chain or a
        # quantized copy of the model (its deploy graph for a ResNet).
        self.int8_impl: Optional[str] = None
        self.int8_chain: Optional[vgg_int8_deploy.Int8Chain] = None
        self.int8_model: Optional[torch.nn.Module] = None
        # shard_for_mesh's mesh and split parameters; enable_pipeline_inference's
        # pipelined forward.
        self._mesh = None
        self._split: Dict[str, int] = {}
        self._pipeline: Optional[Callable] = None

        cfg = network_config["training"]["config"]
        out_res = list(self.net_output_resolution_from_input_resolution(
            self.trained_net_input_resolution()
        ))
        if "net_output_resolution" in cfg and list(cfg["net_output_resolution"]) != out_res:
            raise ValueError("Network model and config file disagree for trained network output resolution.")
        cfg.setdefault("net_output_resolution", out_res)

    @classmethod
    def from_checkpoint(cls, network_config: Dict[str, Any], network_params_path: str,
                        device: Any = "cuda", seed: int = 0) -> "DreamNetwork":
        """The network ``network_config`` describes, holding the flax
        checkpoint at ``network_params_path``: the model is built on the
        meta device, where nothing is drawn (the draws are most of a build's
        time on a CPU), given storage on ``device``, its non-persistent
        buffers set as built, and loaded whole.  ``seed`` is the one
        :meth:`init_variables` redraws from."""
        device = resolve_device(device)
        with torch.device("meta"):
            network = cls(network_config, device="meta", seed=seed)
        network.device = device
        network.model = network.model.to_empty(device=device).eval()
        for module in network.model.modules():
            if hasattr(module, "reset_buffers"):
                module.reset_buffers()
        network.load_network_params(network_params_path)
        return network

    # --- getters (reference dream/network.py:319-326) ---

    def trained_net_input_resolution(self) -> Tuple[int, int]:
        return tuple(self.network_config["training"]["config"]["net_input_resolution"])

    def trained_net_output_resolution(self) -> Tuple[int, int]:
        return tuple(self.network_config["training"]["config"]["net_output_resolution"])

    def image_preprocessing(self) -> str:
        return self.network_config["architecture"]["image_preprocessing"]

    def net_output_resolution_from_input_resolution(self, net_input_resolution):
        """Analytic, from the architecture and its options (reference
        dream/network.py:397-418, ``dream_tpu/network.py:333-340``)."""
        return res_utils.net_output_resolution_from_input_resolution(
            net_input_resolution, self.architecture_type, **self._arch_kwargs
        )

    def net_resolutions_from_image_raw_resolution(self, image_raw_resolution,
                                                  image_preprocessing_override: Optional[str] = None):
        """Parity: reference dream/network.py:368-395."""
        net_input_resolution = res_utils.resolution_after_preprocessing(
            image_raw_resolution, self.trained_net_input_resolution(),
            image_preprocessing_override or self.image_preprocessing()
        )
        return net_input_resolution, self.net_output_resolution_from_input_resolution(
            net_input_resolution
        )

    def peak_offset_due_to_upsampling(self) -> float:
        w, h = self.trained_net_output_resolution()
        # Heuristic for small belief maps (reference dream/network.py:534-538).
        return 0.0 if (w >= 400 and h >= 400) else 0.4395

    # --- parameters (reference dream/network.py:592-632) ---

    def init_variables(self, seed: Optional[int] = None, force: bool = False) -> Dict[str, torch.Tensor]:
        """The model's state (parameters and BatchNorm running statistics);
        with ``force``, first redrawn from ``seed`` (the constructor's seed if
        None) with flax's initial values.
        The constructor has already drawn them (or :meth:`from_checkpoint`
        loaded a checkpoint's), so without ``force`` nothing changes, as
        ``dream_tpu``'s call is idempotent."""
        if force:
            self.release_scanned_graph()
            generator = torch.Generator().manual_seed(self._seed if seed is None else seed)
            self.model.reset_parameters(generator)
        return self.model.state_dict()

    def load_network_params(self, network_params_path: str) -> None:
        """Load flax msgpack weights, and a ResNet's ``batch_stats`` (float16
        storage is widened to float32, ``dream_tpu/network.py:1146-1156``)."""
        state = state_from_flax(load_flax_checkpoint(network_params_path))
        self.release_scanned_graph()
        self.model.load_state_dict(state, strict=True)

    def init_encoder_from(self, encoder_params_path: str) -> Tuple[int, int]:
        """Warm-start from a flax msgpack file holding an encoder subtree
        (``down1`` .. ``down5``) or a whole checkpoint: every leaf of a
        same-named subtree whose shape matches is grafted
        (:func:`dream_tpu_torch.models.pretrain.graft_encoder_params`).
        Returns ``(n_grafted, n_skipped)`` leaf counts."""
        state = self.model.state_dict()
        params = state_to_flax(state)["params"]
        merged, n_grafted, n_skipped = graft_encoder_params(
            params, load_flax_checkpoint(encoder_params_path))
        if n_grafted == 0:
            raise ValueError(f"No encoder weights from {encoder_params_path} matched this model's "
                             "parameters (wrong architecture?)")
        self.release_scanned_graph()
        self.model.load_state_dict({**state, **params_from_flax({"params": merged})}, strict=True)
        return n_grafted, n_skipped

    def save_network_config(self, config_file_path: str, overwrite: bool = False) -> None:
        """Write the config, with ``compute_dtype`` the dtype that runs."""
        config = copy.deepcopy(self.network_config)
        config["architecture"]["compute_dtype"] = dtype_name(self.compute_dtype)
        save_yaml(config, config_file_path, overwrite=overwrite)

    def save_network_params(self, network_params_path: str, overwrite: bool = False) -> None:
        """Write the variables as ``dream_tpu``'s ``save_network_params``
        does: flax msgpack of ``{"params"}``, plus ``{"batch_stats"}`` for a
        ResNet, float32, HWIO."""
        state = self.full_state()  # collective on a mesh: every rank calls
        if self._mesh is not None and self._mesh.rank != 0:
            return
        if not overwrite and os.path.exists(network_params_path):
            raise FileExistsError(f'Output file already exists in "{network_params_path}".')
        save_flax_checkpoint(network_params_path, state_to_flax(state))

    def save_network(self, output_dir: str, output_filename_without_extension: str,
                     overwrite: bool = False) -> None:
        """``<stem>.yaml`` sidecar plus ``<stem>.msgpack`` weights in ``output_dir``."""
        stem = os.path.join(output_dir, output_filename_without_extension)
        if self._mesh is None or self._mesh.rank == 0:
            os.makedirs(output_dir, exist_ok=True)
            self.save_network_config(stem + ".yaml", overwrite)
        self.save_network_params(stem + ".msgpack", overwrite)

    # --- training (reference dream/network.py:328-364, 634-696) ---

    def enable_training(self) -> None:
        """Build the optimizer from ``training.config.optimizer``: Adam or SGD
        at ``learning_rate``, an optional cosine schedule (with warmup)
        stepped once a step, and optional global-norm clipping.

        The learning rate is a 0-d float32 tensor on the device that each
        step computes from the step count there
        (:func:`warmup_cosine_decay_device`), as optax does; SGD is
        :class:`DeviceSGD`.  On the card Adam keeps its own count on the
        device too (``capturable=True``), so every step, eager or replayed
        from a CUDA graph, runs the same kernels; that flag is all that
        differs from the CPU's step."""
        if self.optimizer is None:
            ocfg = self.network_config["training"]["config"]["optimizer"]
            optimizer_type = ocfg["type"]
            if optimizer_type not in KNOWN_OPTIMIZERS:
                raise ValueError(
                    f'Expected optimizer_type "{optimizer_type}" to be in the list '
                    "of known optimizers, but it is not."
                )
            lr = float(ocfg["learning_rate"])
            params = list(self.model.parameters())
            lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
            self.optimizer = (torch.optim.Adam(params, lr=lr_t, capturable=self.device.type == "cuda")
                              if optimizer_type == "adam" else DeviceSGD(params, lr=lr_t))
            self._count = torch.full((), self.steps, dtype=torch.int32, device=self.device)
            schedule = ocfg.get("schedule")
            if schedule:
                if schedule["type"] != "cosine":
                    raise ValueError(f"unknown schedule {schedule}")
                self._schedule = functools.partial(
                    warmup_cosine_decay_device, peak_value=lr,
                    warmup_steps=int(schedule.get("warmup_steps", 0)),
                    decay_steps=int(schedule["decay_steps"]),
                    end_value=float(schedule.get("end_value", 0.0)))
            clip = ocfg.get("grad_clip_norm")
            self._clip_norm = float(clip) if clip else None

    def optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's state as the optax state tree ``dream_tpu`` writes
        to ``.opt.msgpack`` (:func:`dream_tpu_torch.checkpoint.optimizer_state_to_flax`),
        numpy arrays on the host."""
        if self.optimizer is None:
            raise RuntimeError("Optimizer must be defined. Use enable_training() first.")
        return optimizer_state_to_flax(self.network_config["training"]["config"]["optimizer"],
                                       self.model.named_parameters(), self.optimizer, self.steps,
                                       whole=self._whole)

    def load_optimizer_state(self, tree: Dict[str, Any]) -> None:
        """Resume from an optax state tree: Adam's moments, the step count
        and the schedule's position.  The optimizer takes new state tensors,
        so a CUDA graph of the step is dropped."""
        self.enable_training()
        self.release_scanned_graph()
        count = optimizer_state_from_flax(tree, self.network_config["training"]["config"]["optimizer"],
                                          self.model.named_parameters(), self.optimizer)
        if count is None:
            return
        self.steps = count
        self._count.fill_(count)

    def enable_ema(self, decay: float) -> None:
        """Keep an exponential moving average of the parameters, updated after
        every train step as ``e * decay + p * (1 - decay)``."""
        if not 0.0 < decay < 1.0:
            raise ValueError(f"EMA decay must be in (0, 1), got {decay}")
        self.release_scanned_graph()
        self.ema_decay = float(decay)
        self.ema_params = {
            name: p.detach().clone() for name, p in self.model.named_parameters()
        }

    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters with the model's current BatchNorm running
        statistics, as a state dict loadable into ``self.model``
        (``dream_tpu/network.py:530-532``: the EMA covers parameters only)."""
        if self.ema_params is None:
            raise RuntimeError("Call enable_ema(decay) first.")
        return {**self.model.state_dict(), **self.ema_params}

    def enable_fused_training(self, batch_processor: Callable) -> None:
        """Train from raw frames: ``train_raw`` runs ``batch_processor``
        (``dream_tpu_torch.data.dataset.make_batch_processor``) and then the
        step."""
        self.enable_training()
        self.release_scanned_graph()
        self._batch_processor = batch_processor
        self._scanning = False

    def enable_scanned_training(self, batch_processor: Callable) -> None:
        """Train whole epochs over a set held on the device
        (``dream_tpu/network.py:582-641``, a ``lax.scan`` of the fused step
        there): :meth:`train_epoch_raw` runs each step's gather, the batch
        processor, forward, loss, backward, clip, optimizer, schedule and
        EMA with no host sync inside the epoch.  On the card the step is
        captured once as a CUDA graph and replayed for each step; on the CPU
        the same step runs in an eager loop (:meth:`train_epoch_raw_plain`).
        Scanning is on one device, as in ``dream_tpu``: on a mesh
        :meth:`train_epoch_raw` raises."""
        self.enable_fused_training(batch_processor)
        self._scanning = True

    def _stage_outputs(self, net_input: torch.Tensor,
                       variables: Optional[Dict[str, torch.Tensor]] = None) -> List[torch.Tensor]:
        """NHWC net input -> the list of stage outputs, NCHW float32 belief
        maps, last stage last (one for the single-stage models)."""
        x = net_input.to(self.device, torch.float32).permute(0, 3, 1, 2)
        if variables is None:
            out = self.model(x)
        else:
            out = torch.func.functional_call(self.model, variables, (x,))
        return out if isinstance(out, list) else [out]

    def _forward_terms(self, net_input: torch.Tensor, target: torch.Tensor,
                       variables: Optional[Dict[str, torch.Tensor]] = None):
        """The criterion's (numerator, denominator) over the stacked stage
        outputs against the broadcast target, accumulated in float32 (float64
        for a float64 model) (``dream_tpu/network.py:373-392``).  The soft-argmax head is not
        trained, as in ``dream_tpu`` (``:380-382``)."""
        if self.soft_argmax_head:
            raise NotImplementedError("training and the loss take the belief-map head alone "
                                      '(output_heads ["belief_maps"])')
        stacked = torch.stack(self._stage_outputs(net_input, variables))
        stacked = stacked.to(torch.promote_types(stacked.dtype, torch.float32))
        target = target.to(self.device, stacked.dtype)
        return self._loss_terms(stacked, target.expand_as(stacked))

    def _data_mesh(self):
        """The mesh when it has a data group to share the batch over, else None."""
        if self._mesh is not None and self._mesh.data_group is not None:
            return self._mesh
        return None

    def _local_rows(self, local: bool, *arrays):
        """This rank's rows of global batches; ``local`` says they are already."""
        if self._mesh is None or local:
            return arrays
        return tuple(mesh_ops.process_local_batch(self._mesh, a) for a in arrays)

    def _update(self, net_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One step's work (forward, loss, backward, clip, optimizer,
        schedule, EMA) but ``steps``; on the card all of it on the device,
        what a CUDA graph of the step holds.  Returns the loss before the
        step."""
        if self.optimizer is None:
            raise RuntimeError("Optimizer must be defined. Use enable_training() first.")
        self.model.train()
        num, den = self._forward_terms(net_input, target)
        mesh = self._data_mesh()
        if mesh is None:
            loss = objective = num / den
        else:
            # The loss over the global batch, whose rows the data ranks share.
            objective, loss = mesh_ops.global_loss(num, den, mesh)
        self.optimizer.zero_grad(set_to_none=True)
        objective.backward()
        self._apply_gradients()
        self.model.eval()
        return loss.detach()

    def _apply_gradients(self) -> None:
        """The step on the gradients the parameters hold: averaged over the
        data group on a mesh, clipped, the learning rate from the step
        count, the optimizer's update, the count moved on and the EMA; all
        on the device."""
        named = [(n, p) for n, p in self.model.named_parameters() if p.grad is not None]
        params = [p for _, p in named]
        mesh = self._data_mesh()
        if mesh is not None:
            mesh_ops.reduce_gradients(params, mesh)
        if self._clip_norm is not None:
            clip_by_global_norm_([p.grad for p in params], self._clip_norm,
                                 [n in self._split for n, _ in named], self._mesh)
        if self._schedule is not None:
            lr = self._schedule(self._count)
            for group in self.optimizer.param_groups:
                group["lr"].copy_(lr)
        self.optimizer.step()
        self._count.add_(1)
        if self.ema_params is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema_params[name]
                    e.copy_(e * self.ema_decay + p * (1.0 - self.ema_decay))

    def _step(self, net_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss = self._update(net_input, target)
        self.steps += 1
        return loss

    def train(self, network_input_heads: Sequence[torch.Tensor], target: torch.Tensor,
              local: bool = False) -> torch.Tensor:
        """One optimization step: ``network_input_heads[0]`` is the NHWC net
        input, ``target`` the ``[B, n_kp, h, w]`` belief maps.  BatchNorm
        normalises with the batch's statistics and moves its running ones.
        Returns the loss before the step as a 0-d tensor on the device (no
        host sync).  On a mesh the arrays are the global batch, or with
        ``local`` this rank's rows of it (a loader that gives each data rank
        its own part of the set, as the training CLI's)."""
        return self._step(*self._local_rows(local, network_input_heads[0], target))

    def train_raw(self, generator: Optional[torch.Generator], raw_images: torch.Tensor,
                  kp_projs_raw: torch.Tensor, local: bool = False) -> torch.Tensor:
        """One step from raw uint8 ``[B, H, W, 3]`` frames and their raw-frame
        key points: the batch processor (``generator``, on the device, drives
        its augmentation), then forward, loss, backward, clip, optimizer,
        schedule and EMA.  ``local`` as in :meth:`train`."""
        if self._batch_processor is None:
            raise RuntimeError("Call enable_fused_training(batch_processor) first.")
        raw_images, kp_projs_raw = self._local_rows(
            local, torch.as_tensor(raw_images), torch.as_tensor(kp_projs_raw))
        # On a mesh the augmentation draws the global batch's parameters and
        # applies this rank's rows of them (``augment_batch``'s shard).
        shard = {} if self._mesh is None else {"shard": (self._mesh.data_index,
                                                          self._mesh.shape["data"])}
        batch = self._batch_processor(generator, raw_images.to(self.device),
                                      kp_projs_raw.to(self.device), **shard)
        return self._step(batch["image_rgb_input"], batch["belief_maps"])

    def _epoch_rows(self, images: torch.Tensor, kp_projs_raw: torch.Tensor, index_matrix
                    ) -> torch.Tensor:
        """``index_matrix`` as int64 rows on the set's device (one upload
        when it is a host array), after the checks of a scanned epoch."""
        if not self._scanning or self._batch_processor is None:
            raise RuntimeError("Call enable_scanned_training(batch_processor) first.")
        if self._mesh is not None:
            raise ValueError("scanned training runs on one device, as in dream_tpu; on a mesh, "
                             "train step by step (train_raw)")
        if _indexed(images.device) != _indexed(self.device) or kp_projs_raw.device != images.device:
            raise ValueError(f"the set lies on {images.device} and {kp_projs_raw.device}, the "
                             f"network on {self.device}")
        rows = torch.as_tensor(index_matrix).to(images.device, torch.int64)
        if rows.dim() != 2:
            raise ValueError(f"index_matrix must be [n_steps, batch], got {tuple(rows.shape)}")
        return rows

    def _scan_update(self, generator: Optional[torch.Generator], images: torch.Tensor,
                     kp_projs_raw: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        """One scanned step's device work: the gather of ``row``, the batch
        processor and :meth:`_update`."""
        batch = self._batch_processor(generator, images[row], kp_projs_raw[row])
        return self._update(batch["image_rgb_input"], batch["belief_maps"])

    def train_epoch_raw_plain(self, generator: Optional[torch.Generator], images: torch.Tensor,
                              kp_projs_raw: torch.Tensor, index_matrix) -> torch.Tensor:
        """:meth:`train_epoch_raw` as an eager loop of the same step on any
        device: the plain version of the CUDA graph, which the CPU runs and
        the card's checks hold the graph's epochs to."""
        rows = self._epoch_rows(images, kp_projs_raw, index_matrix)
        losses = torch.empty(rows.shape[0], dtype=torch.float32, device=images.device)
        for i in range(rows.shape[0]):
            losses[i] = self._scan_update(generator, images, kp_projs_raw, rows[i])
            self.steps += 1
        return losses

    def train_epoch_raw(self, generator: Optional[torch.Generator], images: torch.Tensor,
                        kp_projs_raw: torch.Tensor, index_matrix) -> torch.Tensor:
        """One epoch over a set held on the device (``dream_tpu/network.py:643-657``):
        a step for each row of ``index_matrix`` (``[n_steps, batch]``
        positions into ``images`` and ``kp_projs_raw``, a host array, e.g.
        ``DeviceCachedLoader.epoch_index_matrix``, uploaded once, or a
        tensor on the device).
        Returns the steps' losses ``[n_steps]`` on the device, with no host
        sync inside the epoch.  Needs :meth:`enable_scanned_training`.

        On the card: where no graph of the step is held for these inputs,
        the epoch's first step runs eagerly on a side stream (cuDNN settles
        its algorithms, the optimizer its state), the second is captured and
        the rest replay the graph; later epochs replay it from their first
        step.  Before each replay the row's positions are copied into the
        graph's index tensor on the device, and after it the loss out of
        it.  A graph is captured anew when the batch shape, the set, the
        generator, the processor, cuDNN's settings or any tensor it holds
        (parameters, buffers, optimizer state, learning rate, EMA) has been
        replaced; a failed capture or replay raises.  On the CPU the epoch
        is :meth:`train_epoch_raw_plain`."""
        if not images.is_cuda:
            return self.train_epoch_raw_plain(generator, images, kp_projs_raw, index_matrix)
        rows = self._epoch_rows(images, kp_projs_raw, index_matrix)
        n_steps = rows.shape[0]
        losses = torch.empty(n_steps, dtype=torch.float32, device=images.device)
        graph, first = self._epoch_graph, 0
        if n_steps and (graph is None or graph.key != self._graph_key(generator, images,
                                                                      kp_projs_raw, rows)):
            self.release_scanned_graph()
            current = torch.cuda.current_stream(images.device)
            side = torch.cuda.Stream(images.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                losses[0] = self._scan_update(generator, images, kp_projs_raw, rows[0])
            current.wait_stream(side)
            self.steps += 1
            first = 1
            if n_steps > 1:
                graph = self._capture_epoch_graph(generator, images, kp_projs_raw, rows)
        for i in range(first, n_steps):
            graph.row.copy_(rows[i])
            graph.graph.replay()
            losses[i].copy_(graph.loss)
        replays = n_steps - first
        if replays:
            self.steps += replays
            warp_batch_kernel.count_replays(graph.warp_launches, replays)
        return losses

    def _graph_key(self, generator, images, kp_projs_raw, rows) -> tuple:
        """What a CUDA graph of the step was captured for: the batch
        size, the set, the generator, the processor, cuDNN's and cuBLAS's
        settings, every tensor the step reads or moves in place (by
        address) and the quantized convs' modes."""
        held = [*self.model.parameters(), *self.model.buffers(), self._count]
        for group in self.optimizer.param_groups:
            held.append(group["lr"])
        for state in self.optimizer.state.values():
            held.extend(v for v in state.values() if torch.is_tensor(v))
        if self.ema_params is not None:
            held.extend(self.ema_params.values())
        return (rows.shape[1], images.data_ptr(), tuple(images.shape), images.dtype,
                kp_projs_raw.data_ptr(), tuple(kp_projs_raw.shape), kp_projs_raw.dtype,
                id(generator), id(self._batch_processor), self._clip_norm, self.ema_decay,
                torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                tuple(t.data_ptr() for t in held),
                tuple(conv.mode for conv in quant_ops.quant_convs(self.model).values()))

    def _capture_epoch_graph(self, generator, images, kp_projs_raw, rows) -> "_EpochGraph":
        """Capture one scanned step (its positions read from a static index
        tensor) as a CUDA graph; capturing runs nothing."""
        key = self._graph_key(generator, images, kp_projs_raw, rows)
        row = rows[1].clone()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        captured_before = warp_batch_kernel.captured
        with torch.cuda.graph(graph):
            loss = self._scan_update(generator, images, kp_projs_raw, row)
        # The graph holds the set and the generator it was captured on, so
        # that the addresses in its key stay theirs.
        self._epoch_graph = _EpochGraph(graph, row, loss, warp_batch_kernel.captured - captured_before,
                                        key, (images, kp_projs_raw, generator))
        return self._epoch_graph

    def release_scanned_graph(self) -> None:
        """Drop the CUDA graph of the scanned step, and the gradients its
        memory pool (one step's activations) holds; the next scanned epoch
        captures anew."""
        if self._epoch_graph is not None:
            self._epoch_graph = None
            if self.optimizer is not None:
                self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def loss(self, network_input_heads: Sequence[torch.Tensor], target: torch.Tensor,
             variables: Optional[Dict[str, torch.Tensor]] = None, local: bool = False
             ) -> torch.Tensor:
        """Evaluation loss, no gradient, BatchNorm on its running statistics;
        ``variables`` (e.g. ``ema_variables()``) replaces the model's state
        for this call only.  On a mesh, the loss of the global batch
        (``local`` as in :meth:`train`)."""
        self.model.eval()
        net_input, target = self._local_rows(local, network_input_heads[0], target)
        num, den = self._forward_terms(net_input, target, variables)
        mesh = self._data_mesh()
        return num / den if mesh is None else mesh_ops.global_loss(num, den, mesh)[1]

    # --- meshes (dream_tpu/network.py:471-510, 750-798) ---

    def shard_for_mesh(self, mesh) -> None:
        """Train on a ``(data, model)`` mesh of ranks
        (:func:`dream_tpu_torch.parallel.make_mesh`; every rank calls this,
        after loading parameters and optimizer state).  The convs
        :func:`~dream_tpu_torch.parallel.param_shardings` selects become
        channel-split convs on the model group (their optimizer state and
        EMA cut to match); :meth:`train_raw` and :meth:`train` take a global
        batch and step on this rank's rows with the loss over the global
        batch, the gradients averaged over the data group and BatchNorm's
        statistics taken over it; checkpoints gather the shards, and rank 0
        alone writes files.  The mesh's device must be the network's."""
        if _indexed(mesh.device) != _indexed(self.device):
            raise ValueError(f"the mesh puts this rank on {mesh.device}, the network is on "
                             f"{self.device}")
        if self.int8_impl is not None or self._pipeline is not None:
            raise ValueError("shard the float network before enabling int8 or pipelined inference")
        self.release_scanned_graph()
        self._mesh = mesh
        self._split = mesh_ops.shard_params(
            self.model, mesh, self.optimizer,
            [self.ema_params] if self.ema_params is not None else [])
        if mesh.data_group is not None:
            for module in self.model.modules():
                if isinstance(module, BatchNorm2d):
                    module.mesh = mesh

    def _whole(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        if name not in self._split:
            return tensor
        return mesh_ops.gather_full(tensor, self._split[name], self._mesh)

    def full_state(self, state: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``state`` (default the model's) whole, in a one-rank run's layout:
        on a mesh with split convs, their shards gathered (collective: every
        rank calls it)."""
        state = self.model.state_dict() if state is None else state
        if not self._split:
            return state
        return mesh_ops.gather_state(state, self._split, self._mesh)

    def enable_pipeline_inference(self, n_microbatches: int = 4, mesh=None) -> List[torch.device]:
        """Run the multistage cascade as a GPipe pipeline, one stage a device
        of ``mesh`` (:func:`dream_tpu_torch.parallel.make_pipeline_mesh`;
        default one stage a GPU), microbatches streaming from stage to stage
        (:func:`~dream_tpu_torch.parallel.pipeline_multistage_inference`);
        the peak decode (the score kernel on the card) takes the final
        stage's maps on its device.  The pipeline holds the current
        parameters.  The batch given to :meth:`inference` must divide by
        ``n_microbatches``.  Returns the stage devices."""
        from dream_tpu_torch.parallel.pipeline import pipeline_multistage_inference

        if not isinstance(self.model, DreamHourglassMultiStage):
            raise ValueError("Pipeline inference applies to the multistage cascade; got "
                             f"{type(self.model).__name__}.")
        if self.int8_impl is not None:
            raise ValueError("the pipeline runs the float cascade; int8 inference is enabled")
        fn, mesh = pipeline_multistage_inference(self.model, None, mesh, n_microbatches)
        self._pipeline = fn
        return mesh

    # --- int8 inference (reference dream/network.py:796-969) ---

    def enable_int8_inference(self, calibration_net_inputs: Sequence[torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
        """Post-training int8 quantization of the conv stack.

        Calibrates the activation amax of every quantizable conv over
        ``calibration_net_inputs`` (normalized NHWC ``[B, H, W, 3]``
        batches) with the float graph, as the JAX package's ``calibrate``
        pass does, then quantizes the current parameters and points
        :meth:`inference` at the int8 graph ``DREAM_INT8_IMPL`` selects
        (:func:`int8_impl_from_env`, ``dream_tpu/network.py:857-906``):

        - ``auto`` takes vgg-Q's chain where it applies
          (``vgg_int8_deploy.supports``), else ``quantconv``;
        - ``xla_chain`` and ``pallas`` name vgg-Q's chain
          (:mod:`dream_tpu_torch.models.vgg_int8_deploy`), whose 19 chained
          convs run in the CUDA int8 conv kernel on the card; asked for on a
          network the chain cannot take, they raise (``dream_tpu`` warns
          and falls back to ``quantconv``);
        - ``quantconv`` is the quantized conv graph
          (:class:`~dream_tpu_torch.models.quant.QuantConv2d` in ``int8``
          mode, the exact int32 route of :mod:`dream_tpu_torch.ops.conv_int32`):
          a quantized copy of the hourglass (every conv but ``head.conv2``
          and vgg-F's deconv decoder), or of a ResNet's BatchNorm-folded
          deploy graph (:mod:`dream_tpu_torch.models.resnet_deploy`).

        The int8 graph is a snapshot: later training does not change it.
        Training and checkpoints stay float.  Calibration runs on a copy of
        the model, so the live model never enters ``calibrate`` mode:
        inference on other threads (the server's handlers) goes on in float
        meanwhile and adds nothing to the amax.  Returns the amax by module
        path.
        """
        if self._mesh is not None or self._pipeline is not None:
            raise ValueError("int8 inference runs on one device, unsharded and unpipelined, as in "
                             "dream_tpu")
        impl = int8_impl_from_env()
        chain_ok = self.architecture_type == "vgg" and vgg_int8_deploy.supports(self.model)
        if impl == "auto":
            impl = "xla_chain" if chain_ok else "quantconv"
        elif impl in ("xla_chain", "pallas") and not chain_ok:
            raise ValueError(
                f"DREAM_INT8_IMPL={impl!r} names vgg-Q's int8 chain, which this network cannot "
                "take (it covers the single-stage quarter-resolution vgg hourglass); use "
                "'quantconv' or 'auto'"
            )
        self.release_scanned_graph()
        batches = (torch.as_tensor(b).to(self.device, torch.float32).permute(0, 3, 1, 2)
                   for b in calibration_net_inputs)
        if self.architecture_type == "resnet":
            graph = ResnetSimpleDeploy(self.n_keypoints, full=self.model.full,
                                       layers=self.model.layers, dtype=self.compute_dtype)
            graph.load_state_dict(fold_batchnorm_resnet(self.model.state_dict()), strict=True)
            graph = graph.to(self.device)
        else:
            graph = copy.deepcopy(self.model)
        qvars = quant_ops.calibrate(graph, batches)
        # One attribute at a time, the new graph last: a reader on another
        # thread sees the old graph or the new one.
        if impl in ("xla_chain", "pallas"):
            chain = vgg_int8_deploy.quantize_chain(self.model.state_dict(), qvars)
            self.int8_model = None
            self.int8_chain = chain
        else:
            self.int8_chain = None
            self.int8_model = quant_ops.set_int8(graph, qvars)
        self.int8_impl = impl
        return qvars

    # --- inference (reference dream/network.py:503-590) ---

    def _outputs(self, network_input: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """NHWC net input -> (float32 belief maps NCHW of the last stage, the
        soft-argmax head's keypoints or None), through the int8 graph once
        :meth:`enable_int8_inference` has run."""
        chain, int8_model = self.int8_chain, self.int8_model  # another thread may set them
        x = network_input.to(self.device, torch.float32)
        if self._pipeline is not None:
            return self._pipeline(x), None
        if chain is not None:
            belief = vgg_int8_deploy.run_int8_chain(chain, x, self.compute_dtype)
            return belief.permute(0, 3, 1, 2).contiguous(), None
        model = int8_model if int8_model is not None else self.model.eval()
        out = model(x.permute(0, 3, 1, 2))
        if self.soft_argmax_head:
            return out[0].to(torch.float32), out[1]
        belief = out[-1] if isinstance(out, list) else out
        # The decode (the score kernel) takes float32 maps.
        return belief.to(torch.float32), None

    def _belief_maps(self, network_input: torch.Tensor) -> torch.Tensor:
        return self._outputs(network_input)[0]

    def _keypoints(self, belief: torch.Tensor):
        return bm_ops.keypoints_from_belief_maps(
            belief,
            self.peak_offset_due_to_upsampling(),
            use_belief_peak_scores=self.use_belief_peak_scores,
            belief_peak_next_best_score=self.belief_peak_next_best_score,
        )

    @torch.no_grad()
    def inference(self, network_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, h, w, 3]`` float net input (channels-last, as the JAX package)
        -> ``(belief_maps [B, n_kp, h', w'], keypoints [B, n_kp, 2])`` in
        the net-output frame, the last stage's maps in float32; the sentinel
        marks no detection.  BatchNorm runs on its running statistics.  Runs
        the int8 graph once :meth:`enable_int8_inference` has been called.
        The soft-argmax head's keypoints are its own, with no peak decode
        (``dream_tpu/network.py:724-733``)."""
        belief, keypoints = self._outputs(network_input)
        if keypoints is not None:
            return belief, keypoints
        return belief, self._keypoints(belief)[0]

    @torch.no_grad()
    def inference_detailed(self, network_input: torch.Tensor):
        """:meth:`inference` plus each map's best peak score ``[B, n_kp]``
        and that peak's net-output coordinates ``[B, n_kp, 2]``, kept even
        where the score-gap disambiguation rejects it to the sentinel: the
        inputs of confidence-weighted and soft-detection PnP.  The
        soft-argmax head's scores are all ones and its best keypoints its
        keypoints (``dream_tpu/network.py:990-998``)."""
        belief, keypoints = self._outputs(network_input)
        if keypoints is not None:
            return belief, keypoints, torch.ones(keypoints.shape[:-1], device=keypoints.device), keypoints
        keypoints, peaks = self._keypoints(belief)
        return belief, keypoints, peaks["scores"][..., 0], peaks["coords"][..., 0, :]

    def enable_evaluation(self) -> None:
        """Inference mode (``dream_tpu/network.py:703``): BatchNorm on its
        running statistics."""
        self.model.eval()

    def preprocess(self, images_u8: torch.Tensor,
                   image_preprocessing_override: Optional[str] = None) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` frames -> normalized float net input on the
        device, in the trained preprocessing mode or in the override."""
        return image_proc_ops.preprocess_and_normalize(
            images_u8.to(self.device),
            self.trained_net_input_resolution(),
            image_preprocessing_override or self.image_preprocessing(),
            self.image_normalization,
        )

    def keypoints_from_image(self, input_rgb_image: np.ndarray,
                             image_preprocessing_override: Optional[str] = None,
                             debug: bool = False, detailed: bool = False) -> Dict[str, Any]:
        """uint8 ``[H, W, 3]`` array -> raw-frame keypoints (reference
        dream/network.py:423-499, ``dream_tpu/network.py:1029-1098``).

        ``image_preprocessing_override`` replaces the trained preprocessing
        mode for this frame.  ``detailed`` adds, through
        :meth:`inference_detailed`, each map's best peak score
        (``peak_scores [n_kp]``) and that peak in the raw frame
        (``best_peak_keypoints [n_kp, 2]``), kept where the score-gap
        disambiguation rejects it: the inputs of soft-detection PnP.
        ``debug`` adds the net input and the belief maps (tensors on the
        device) and the net-output / net-input frame keypoints."""
        image = np.asarray(input_rgb_image, dtype=np.uint8)
        input_resolution = (image.shape[1], image.shape[0])
        preprocessing = image_preprocessing_override or self.image_preprocessing()
        netin_res, _ = self.net_resolutions_from_image_raw_resolution(input_resolution, preprocessing)
        net_input = self.preprocess(torch.from_numpy(image)[None], preprocessing)
        if detailed:
            belief_maps, kp_netout, peak_scores, best_netout = self.inference_detailed(net_input)
        else:
            belief_maps, kp_netout = self.inference(net_input)
        netout_res_inf = (belief_maps.shape[-1], belief_maps.shape[-2])

        def to_raw(kp_netout_frame):
            kp_netin = coord_ops.convert_keypoints_to_netin_from_netout(
                kp_netout_frame, netout_res_inf, netin_res
            )
            return kp_netin, np.asarray(coord_ops.convert_keypoints_to_raw_from_netin(
                kp_netin, netin_res, input_resolution, preprocessing
            ))

        detected_netout = kp_netout[0].cpu().numpy().astype(float)
        kp_netin, detected = to_raw(detected_netout)
        result = {"detected_keypoints": detected}
        if detailed:
            result["peak_scores"] = peak_scores[0].cpu().numpy()
            result["best_peak_keypoints"] = to_raw(best_netout[0].cpu().numpy().astype(float))[1]
        if debug:
            result["image_rgb_net_input"] = net_input[0]
            result["belief_maps"] = belief_maps[0]
            result["detected_keypoints_net_output"] = detected_netout
            result["detected_keypoints_net_input"] = np.asarray(kp_netin)
        return result
