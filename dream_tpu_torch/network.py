"""DreamNetwork: the config-driven facade of the port, inference and training.

Port of ``dream_tpu/network.py`` for the vgg-Q configuration: build the
model from a self-describing YAML config, load and save flax msgpack
weights with their YAML sidecar, run ``image -> (belief_maps, keypoints)``
on one device, and train: the belief-map criteria (``:70-118``), the
optimizer with its schedule and global-norm clipping (``:394-435``), the
train steps (``:437``, ``:534-580``, ``:659-687``), the EMA (``:512-532``)
and the evaluation loss (``:689``); quantization-aware training
(``quant_mode: qat``, ``:190-200``) and int8 inference of vgg-Q
(``enable_int8_inference``, ``:796-969``).  The model computes in float32:
a config's ``compute_dtype`` bfloat16 is not ported yet, so such a config
warns, ``compute_dtype`` says float32, and a saved sidecar says so too.
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
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dream_tpu_torch.checkpoint import (
    load_flax_checkpoint,
    params_from_flax,
    params_to_flax,
    save_flax_checkpoint,
)
from dream_tpu_torch.models import DreamHourglass
from dream_tpu_torch.models import quant as quant_ops
from dream_tpu_torch.models import vgg_int8_deploy
from dream_tpu_torch.ops import belief_maps as bm_ops
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import image_proc as image_proc_ops
from dream_tpu_torch.utils import resolutions as res_utils
from dream_tpu_torch.utils.config import load_yaml, save_yaml

KNOWN_OPTIMIZERS = ["adam", "sgd"]  # reference dream/network.py:23-26


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
    """Config-validated vgg-Q model + decode + coordinate maps + training."""

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
        self.n_keypoints = len(self.keypoint_names)
        self.architecture_type = arch["type"]
        self.image_normalization = arch["image_normalization"]
        if self.image_preprocessing() not in res_utils.KNOWN_IMAGE_PREPROC_TYPES:
            raise ValueError(f'Image preprocessing type "{self.image_preprocessing()}" is not recognized.')
        if arch["input_heads"][0] != "image_rgb":
            raise ValueError('First input head must be "image_rgb".')
        unported = [k for k in ("spatial_softmax", "deconv_decoder", "full_output",
                                "skip_connections", "n_stages") if k in arch]
        if self.architecture_type != "vgg" or arch["output_heads"] != ["belief_maps"] or unported:
            raise NotImplementedError(
                "the port runs the vgg upsample-decoder hourglass (vgg-Q) only so far; "
                f"got type={self.architecture_type} output_heads={arch['output_heads']} "
                f"options={unported}"
            )
        # QAT fake-quantizes the training graph; calibrate/int8 are driven by
        # enable_int8_inference (dream_tpu/network.py:190-200).
        self.quant_mode = arch.get("quant_mode")
        if self.quant_mode not in (None, "qat"):
            raise NotImplementedError(
                f'architecture "quant_mode" must be null or "qat", got {self.quant_mode!r}'
            )
        # The dtype the model runs in: float32 (bf16 compute is not ported).
        self.compute_dtype = torch.float32
        requested = arch.get("compute_dtype", "float32")
        if requested != dtype_name(self.compute_dtype):
            warnings.warn(
                f'the config asks for compute_dtype "{requested}"; the port computes in '
                f'"{dtype_name(self.compute_dtype)}"',
                stacklevel=2,
            )

        # Multi-peak disambiguation knobs (reference dream/network.py:187-191).
        self.use_belief_peak_scores = True
        self.belief_peak_next_best_score = 0.25

        self._seed = seed
        self.model = DreamHourglass(
            self.n_keypoints, generator=torch.Generator().manual_seed(seed),
            quant_mode=self.quant_mode,
        ).to(self.device).eval()
        self.criterion = criterion_from_config(arch["loss"])
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
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
        return res_utils.net_output_resolution_from_input_resolution(net_input_resolution, "vgg")

    def net_resolutions_from_image_raw_resolution(self, image_raw_resolution):
        """Parity: reference dream/network.py:368-395."""
        net_input_resolution = res_utils.resolution_after_preprocessing(
            image_raw_resolution, self.trained_net_input_resolution(), self.image_preprocessing()
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
        """The model's parameters; with ``force``, first redrawn from ``seed``
        (the constructor's seed if None) with flax's initial distributions.
        The constructor has already drawn them, so without ``force`` nothing
        changes, as ``dream_tpu``'s call is idempotent."""
        if force:
            generator = torch.Generator().manual_seed(self._seed if seed is None else seed)
            self.model.reset_parameters(generator)
        return self.model.state_dict()

    def load_network_params(self, network_params_path: str) -> None:
        """Load flax msgpack weights (float16 storage is widened to float32)."""
        state = params_from_flax(load_flax_checkpoint(network_params_path))
        self.model.load_state_dict(state, strict=True)

    def save_network_config(self, config_file_path: str, overwrite: bool = False) -> None:
        """Write the config, with ``compute_dtype`` the dtype that ran."""
        config = copy.deepcopy(self.network_config)
        config["architecture"]["compute_dtype"] = dtype_name(self.compute_dtype)
        save_yaml(config, config_file_path, overwrite=overwrite)

    def save_network_params(self, network_params_path: str, overwrite: bool = False) -> None:
        """Write the parameters as ``dream_tpu``'s ``save_network_params``
        does (flax msgpack of ``{"params": ...}``, float32, HWIO)."""
        if not overwrite and os.path.exists(network_params_path):
            raise FileExistsError(f'Output file already exists in "{network_params_path}".')
        save_flax_checkpoint(network_params_path, params_to_flax(self.model.state_dict()))

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

                self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, factor)
            clip = ocfg.get("grad_clip_norm")
            self._clip_norm = float(clip) if clip else None

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
        """The EMA parameters as a state dict (loadable into ``self.model``)."""
        if self.ema_params is None:
            raise RuntimeError("Call enable_ema(decay) first.")
        return dict(self.ema_params)

    def enable_fused_training(self, batch_processor: Callable) -> None:
        """Train from raw frames: ``train_raw`` runs ``batch_processor``
        (``dream_tpu_torch.data.dataset.make_batch_processor``) and then the
        step."""
        self.enable_training()
        self._batch_processor = batch_processor

    def _forward_loss(self, net_input: torch.Tensor, target: torch.Tensor,
                      params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        x = net_input.to(self.device, torch.float32).permute(0, 3, 1, 2)
        if params is None:
            pred = self.model(x)
        else:
            pred = torch.func.functional_call(self.model, params, (x,))
        # The criterion accumulates in float32, as loss_fn does.
        return self.criterion(pred.to(torch.float32), target.to(self.device, torch.float32))

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
        input, ``target`` the ``[B, n_kp, h, w]`` belief maps.  Returns the
        loss before the step as a 0-d tensor on the device (no host sync)."""
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

    @torch.no_grad()
    def loss(self, network_input_heads: Sequence[torch.Tensor], target: torch.Tensor,
             variables: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Evaluation loss, no gradient; ``variables`` (e.g. ``ema_variables()``)
        replaces the model's parameters for this call only."""
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
        """
        if not vgg_int8_deploy.supports(self.model):
            raise NotImplementedError("int8 inference is ported for vgg-Q only")
        batches = (torch.as_tensor(b).to(self.device, torch.float32).permute(0, 3, 1, 2)
                   for b in calibration_net_inputs)
        qvars = quant_ops.calibrate(self.model, batches)
        self.int8_chain = vgg_int8_deploy.quantize_chain(self.model.state_dict(), qvars)
        return qvars

    # --- inference (reference dream/network.py:503-590) ---

    @torch.no_grad()
    def inference(self, network_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, h, w, 3]`` float net input (channels-last, as the JAX package)
        -> ``(belief_maps [B, n_kp, h/4, w/4], keypoints [B, n_kp, 2])`` in
        the net-output frame; the sentinel marks no detection.  Runs the int8
        chain once :meth:`enable_int8_inference` has been called."""
        if self.int8_chain is not None:
            belief = vgg_int8_deploy.run_int8_chain(
                self.int8_chain, network_input.to(self.device, torch.float32), self.compute_dtype
            ).permute(0, 3, 1, 2).contiguous()
        else:
            belief = self.model(network_input.to(self.device, torch.float32).permute(0, 3, 1, 2))
        keypoints, _ = bm_ops.keypoints_from_belief_maps(
            belief,
            self.peak_offset_due_to_upsampling(),
            use_belief_peak_scores=self.use_belief_peak_scores,
            belief_peak_next_best_score=self.belief_peak_next_best_score,
        )
        return belief, keypoints

    def preprocess(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` frames -> normalized float net input on the device."""
        return image_proc_ops.preprocess_and_normalize(
            images_u8.to(self.device),
            self.trained_net_input_resolution(),
            self.image_preprocessing(),
            self.image_normalization,
        )

    def keypoints_from_image(self, input_rgb_image: np.ndarray, debug: bool = False) -> Dict[str, Any]:
        """uint8 ``[H, W, 3]`` array -> raw-frame keypoints (reference
        dream/network.py:423-499); ``debug`` adds the net input, the belief
        maps and the net-output / net-input frame keypoints."""
        image = np.asarray(input_rgb_image, dtype=np.uint8)
        input_resolution = (image.shape[1], image.shape[0])
        netin_res, _ = self.net_resolutions_from_image_raw_resolution(input_resolution)
        net_input = self.preprocess(torch.from_numpy(image)[None])
        belief_maps, kp_netout = self.inference(net_input)
        detected_netout = kp_netout[0].cpu().numpy().astype(float)
        netout_res_inf = (belief_maps.shape[-1], belief_maps.shape[-2])
        kp_netin = coord_ops.convert_keypoints_to_netin_from_netout(
            detected_netout, netout_res_inf, netin_res
        )
        detected = coord_ops.convert_keypoints_to_raw_from_netin(
            kp_netin, netin_res, input_resolution, self.image_preprocessing()
        )
        result = {"detected_keypoints": np.asarray(detected)}
        if debug:
            result["image_rgb_net_input"] = net_input[0]
            result["belief_maps"] = belief_maps[0]
            result["detected_keypoints_net_output"] = detected_netout
            result["detected_keypoints_net_input"] = np.asarray(kp_netin)
        return result
