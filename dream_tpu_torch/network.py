"""DreamNetwork: the config-driven facade of the port, inference and training.

Port of ``dream_tpu/network.py``: build the model a self-describing YAML
config names (``:197-264``: the vgg hourglasses, single- or multistage, and
ResNet-H/F), load and save flax msgpack weights with their YAML sidecar,
run ``image -> (belief_maps, keypoints)`` on one device, and train: the
belief-map criteria (``:70-118``), the multistage loss (``:373-392``), the
optimizer with its schedule and global-norm clipping (``:394-435``), the
train steps with BatchNorm's running statistics (``:437-460``), the EMA
(``:512-532``) and the evaluation loss; quantization-aware training of the
vgg hourglasses (``quant_mode: qat``) and int8 inference of vgg-Q
(``enable_int8_inference``, ``:796-969``); the decode's peak scores
for the robust PnP modes (``inference_detailed``, ``:984-1028``); and
warm starts from a pretrained encoder (``init_encoder_from``,
``:1116-1145``) and, across packages, from an optax optimizer state
(``optimizer_state``, ``load_optimizer_state``).  The model computes in the
config's ``compute_dtype``, float32 or bfloat16, with float32 parameters,
as the JAX package does.  The soft-argmax head is not ported yet.
Peak decoding runs in the CUDA score kernel, the augmentation's warp in
the CUDA warp kernel and the int8 chain's convs in the CUDA int8 conv
kernel for CUDA tensors, and in their plain torch versions for CPU
tensors, chosen by the tensor's device.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of falling back.
"""

from __future__ import annotations

import copy
import math
import os
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
from dream_tpu_torch.models import DreamHourglass, DreamHourglassMultiStage, ResnetSimple
from dream_tpu_torch.models import quant as quant_ops
from dream_tpu_torch.models import vgg_int8_deploy
from dream_tpu_torch.models.pretrain import graft_encoder_params
from dream_tpu_torch.ops import belief_maps as bm_ops
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import image_proc as image_proc_ops
from dream_tpu_torch.utils import resolutions as res_utils
from dream_tpu_torch.utils.config import load_yaml, save_yaml

KNOWN_OPTIMIZERS = ["adam", "sgd"]  # reference dream/network.py:23-26
KNOWN_ARCHITECTURES = ["vgg", "resnet"]
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def create_network_from_config_file(
    config_file_path: str, network_params_path: Optional[str] = None,
    device: Any = "cuda",
) -> "DreamNetwork":
    """Parity: ``dream_tpu.network.create_network_from_config_file``."""
    if not os.path.exists(config_file_path):
        raise FileNotFoundError(config_file_path)
    network = DreamNetwork(load_yaml(config_file_path), device=device)
    if network_params_path:
        if not os.path.exists(network_params_path):
            raise FileNotFoundError(network_params_path)
        network.load_network_params(network_params_path)
    return network


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def huber_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch SmoothL1Loss (beta=1) semantics."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def weighted_mse_loss(pos_weight: float, symmetric: bool = False) -> Callable:
    """MSE with pixel weights ``1 + (pos_weight - 1) * t``, normalised by
    their sum, where ``t`` is the target clipped to [0, 1] or, when
    ``symmetric``, ``max(t, clip(pred, 0, 1))`` with no gradient through the
    prediction's weight (``dream_tpu/network.py:78-118``)."""

    def criterion(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(target, 0.0, 1.0)
        if symmetric:
            p = torch.clamp(pred.detach().to(torch.float32), 0.0, 1.0)
            t = torch.maximum(t, p)
        w = 1.0 + (pos_weight - 1.0) * t
        return torch.sum(w * (pred - target) ** 2) / torch.sum(w)

    return criterion


def criterion_from_config(loss_config: Dict[str, Any]) -> Callable:
    """The criterion named by ``architecture.loss`` (``network.py:299-309``)."""
    loss_type = loss_config["type"]
    if loss_type == "mse":
        return mse_loss
    if loss_type == "huber":
        return huber_loss
    if loss_type == "weighted_mse":
        return weighted_mse_loss(
            float(loss_config.get("pos_weight", 100.0)),
            symmetric=bool(loss_config.get("symmetric", False)),
        )
    raise NotImplementedError(f'Loss "{loss_type}" not yet implemented.')


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


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip in place as ``optax.clip_by_global_norm``: with ``norm`` the
    global L2 norm, every ``g`` becomes ``(g / norm) * max_norm`` when
    ``norm >= max_norm`` and stays otherwise (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead).  Selected on the device, with no host sync;
    returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class DreamNetwork:
    """Config-validated model + decode + coordinate maps + training."""

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
        if "spatial_softmax" in arch or arch["output_heads"] != ["belief_maps"]:
            raise NotImplementedError(
                "the port has no soft-argmax head yet; "
                f"got output_heads={arch['output_heads']}"
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
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
        self._lr_factor: Optional[Callable[[int], float]] = None
        self.steps = 0  # optimizer steps taken, optax's ``count``
        self._clip_norm: Optional[float] = None
        self._batch_processor: Optional[Callable] = None
        self.ema_decay: Optional[float] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self.int8_chain: Optional[vgg_int8_deploy.Int8Chain] = None

        cfg = network_config["training"]["config"]
        out_res = list(self.net_output_resolution_from_input_resolution(
            self.trained_net_input_resolution()
        ))
        if "net_output_resolution" in cfg and list(cfg["net_output_resolution"]) != out_res:
            raise ValueError("Network model and config file disagree for trained network output resolution.")
        cfg.setdefault("net_output_resolution", out_res)

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
        The constructor has already drawn them, so without ``force`` nothing
        changes, as ``dream_tpu``'s call is idempotent."""
        if force:
            generator = torch.Generator().manual_seed(self._seed if seed is None else seed)
            self.model.reset_parameters(generator)
        return self.model.state_dict()

    def load_network_params(self, network_params_path: str) -> None:
        """Load flax msgpack weights, and a ResNet's ``batch_stats`` (float16
        storage is widened to float32, ``dream_tpu/network.py:1146-1156``)."""
        state = state_from_flax(load_flax_checkpoint(network_params_path))
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
        if not overwrite and os.path.exists(network_params_path):
            raise FileExistsError(f'Output file already exists in "{network_params_path}".')
        save_flax_checkpoint(network_params_path, state_to_flax(self.model.state_dict()))

    def save_network(self, output_dir: str, output_filename_without_extension: str,
                     overwrite: bool = False) -> None:
        """``<stem>.yaml`` sidecar plus ``<stem>.msgpack`` weights in ``output_dir``."""
        os.makedirs(output_dir, exist_ok=True)
        stem = os.path.join(output_dir, output_filename_without_extension)
        self.save_network_config(stem + ".yaml", overwrite)
        self.save_network_params(stem + ".msgpack", overwrite)

    # --- training (reference dream/network.py:328-364, 634-696) ---

    def enable_training(self) -> None:
        """Build the optimizer from ``training.config.optimizer``: Adam or SGD
        at ``learning_rate``, an optional cosine schedule (with warmup)
        stepped once a step, and optional global-norm clipping."""
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
            if optimizer_type == "adam":
                self.optimizer = torch.optim.Adam(params, lr=lr)
            else:
                self.optimizer = torch.optim.SGD(params, lr=lr)
            schedule = ocfg.get("schedule")
            if schedule:
                if schedule["type"] != "cosine":
                    raise ValueError(f"unknown schedule {schedule}")
                warmup = int(schedule.get("warmup_steps", 0))
                decay = int(schedule["decay_steps"])
                end = float(schedule.get("end_value", 0.0))

                def factor(step: int) -> float:
                    value = warmup_cosine_decay(step, lr, warmup, decay, end)
                    return value / lr if lr else 0.0

                self._lr_factor = factor
                self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, factor)
            clip = ocfg.get("grad_clip_norm")
            self._clip_norm = float(clip) if clip else None

    def optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's state as the optax state tree ``dream_tpu`` writes
        to ``.opt.msgpack`` (:func:`dream_tpu_torch.checkpoint.optimizer_state_to_flax`),
        numpy arrays on the host."""
        if self.optimizer is None:
            raise RuntimeError("Optimizer must be defined. Use enable_training() first.")
        return optimizer_state_to_flax(self.network_config["training"]["config"]["optimizer"],
                                       self.model.named_parameters(), self.optimizer, self.steps)

    def load_optimizer_state(self, tree: Dict[str, Any]) -> None:
        """Resume from an optax state tree: Adam's moments, the step count
        and the schedule's position."""
        self.enable_training()
        count = optimizer_state_from_flax(tree, self.network_config["training"]["config"]["optimizer"],
                                          self.model.named_parameters(), self.optimizer)
        if count is None:
            return
        self.steps = count
        if self.scheduler is not None:
            lrs = [base * self._lr_factor(count) for base in self.scheduler.base_lrs]
            state = self.scheduler.state_dict()
            state.update(last_epoch=count, _step_count=count + 1, _last_lr=lrs)
            self.scheduler.load_state_dict(state)
            for group, lr in zip(self.optimizer.param_groups, lrs):
                group["lr"] = lr

    def enable_ema(self, decay: float) -> None:
        """Keep an exponential moving average of the parameters, updated after
        every train step as ``e * decay + p * (1 - decay)``."""
        if not 0.0 < decay < 1.0:
            raise ValueError(f"EMA decay must be in (0, 1), got {decay}")
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
        self._batch_processor = batch_processor

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

    def _forward_loss(self, net_input: torch.Tensor, target: torch.Tensor,
                      variables: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The criterion over the stacked stage outputs against the broadcast
        target, accumulated in float32 (``dream_tpu/network.py:373-392``)."""
        stacked = torch.stack(self._stage_outputs(net_input, variables)).to(torch.float32)
        target = target.to(self.device, torch.float32)
        return self.criterion(stacked, target.expand_as(stacked))

    def _step(self, net_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.optimizer is None:
            raise RuntimeError("Optimizer must be defined. Use enable_training() first.")
        self.model.train()
        loss = self._forward_loss(net_input, target)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in self.model.parameters() if p.grad is not None]
        if self._clip_norm is not None:
            clip_by_global_norm_([p.grad for p in params], self._clip_norm)
        self.optimizer.step()
        self.steps += 1
        if self.scheduler is not None:
            self.scheduler.step()
        if self.ema_params is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema_params[name]
                    e.copy_(e * self.ema_decay + p * (1.0 - self.ema_decay))
        self.model.eval()
        return loss.detach()

    def train(self, network_input_heads: Sequence[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
        """One optimization step: ``network_input_heads[0]`` is the NHWC net
        input, ``target`` the ``[B, n_kp, h, w]`` belief maps.  BatchNorm
        normalises with the batch's statistics and moves its running ones.
        Returns the loss before the step as a 0-d tensor on the device (no
        host sync)."""
        return self._step(network_input_heads[0], target)

    def train_raw(self, generator: Optional[torch.Generator], raw_images: torch.Tensor,
                  kp_projs_raw: torch.Tensor) -> torch.Tensor:
        """One step from raw uint8 ``[B, H, W, 3]`` frames and their raw-frame
        key points: the batch processor (``generator``, on the device, drives
        its augmentation), then forward, loss, backward, clip, optimizer,
        schedule and EMA."""
        if self._batch_processor is None:
            raise RuntimeError("Call enable_fused_training(batch_processor) first.")
        batch = self._batch_processor(
            generator, torch.as_tensor(raw_images).to(self.device),
            torch.as_tensor(kp_projs_raw).to(self.device),
        )
        return self._step(batch["image_rgb_input"], batch["belief_maps"])

    def train_epoch_raw(self, generator: Optional[torch.Generator], images: torch.Tensor,
                        kp_projs_raw: torch.Tensor, index_matrix) -> torch.Tensor:
        """One epoch over a set held on the device: a :meth:`train_raw` step
        for each row of ``index_matrix`` (``[n_steps, batch]`` positions into
        ``images`` and ``kp_projs_raw``, e.g.
        ``DeviceCachedLoader.epoch_index_matrix``).  Returns the steps'
        losses ``[n_steps]`` on the device."""
        rows = torch.as_tensor(np.asarray(index_matrix), device=images.device)
        losses = [self.train_raw(generator, images[row], kp_projs_raw[row]) for row in rows]
        return torch.stack(losses) if losses else torch.zeros(0, device=images.device)

    @torch.no_grad()
    def loss(self, network_input_heads: Sequence[torch.Tensor], target: torch.Tensor,
             variables: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Evaluation loss, no gradient, BatchNorm on its running statistics;
        ``variables`` (e.g. ``ema_variables()``) replaces the model's state
        for this call only."""
        self.model.eval()
        return self._forward_loss(network_input_heads[0], target, variables)

    # --- int8 inference (reference dream/network.py:796-969) ---

    def enable_int8_inference(self, calibration_net_inputs: Sequence[torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
        """Post-training int8 quantization of vgg-Q's conv stack.

        Calibrates the activation amax of every quantizable conv over
        ``calibration_net_inputs`` (normalized NHWC ``[B, H, W, 3]``
        batches) with the float model, as the JAX package's ``calibrate``
        pass does, then quantizes the current parameters and points
        :meth:`inference` at the int8 chain
        (:mod:`dream_tpu_torch.models.vgg_int8_deploy`), whose 19 chained
        convs run in the CUDA int8 conv kernel on the card.  The chain is a
        snapshot: later training does not change it.  Training and
        checkpoints stay float.  Returns the amax by module path.

        Calibration runs on a copy of the model, so the live model never
        enters ``calibrate`` mode: inference on other threads (the server's
        handlers) goes on in float meanwhile and adds nothing to the amax.
        """
        if not vgg_int8_deploy.supports(self.model):
            raise NotImplementedError(
                "int8 inference is ported for vgg-Q only; vgg-F, the other hourglasses and the "
                "ResNets need QuantConv's int8 mode, not ported yet"
            )
        batches = (torch.as_tensor(b).to(self.device, torch.float32).permute(0, 3, 1, 2)
                   for b in calibration_net_inputs)
        qvars = quant_ops.calibrate(copy.deepcopy(self.model), batches)
        self.int8_chain = vgg_int8_deploy.quantize_chain(self.model.state_dict(), qvars)
        return qvars

    # --- inference (reference dream/network.py:503-590) ---

    def _belief_maps(self, network_input: torch.Tensor) -> torch.Tensor:
        chain = self.int8_chain  # one read: another thread may set it meanwhile
        if chain is not None:
            belief = vgg_int8_deploy.run_int8_chain(
                chain, network_input.to(self.device, torch.float32), self.compute_dtype
            ).permute(0, 3, 1, 2).contiguous()
        else:
            self.model.eval()
            belief = self._stage_outputs(network_input)[-1]
        # The decode (the score kernel) takes float32 maps.
        return belief.to(torch.float32)

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
        the int8 chain once :meth:`enable_int8_inference` has been called."""
        belief = self._belief_maps(network_input)
        return belief, self._keypoints(belief)[0]

    @torch.no_grad()
    def inference_detailed(self, network_input: torch.Tensor):
        """:meth:`inference` plus each map's best peak score ``[B, n_kp]``
        and that peak's net-output coordinates ``[B, n_kp, 2]``, kept even
        where the score-gap disambiguation rejects it to the sentinel: the
        inputs of confidence-weighted and soft-detection PnP."""
        belief = self._belief_maps(network_input)
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
