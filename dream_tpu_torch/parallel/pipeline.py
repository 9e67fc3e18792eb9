"""GPipe stage pipelining of the multistage hourglass cascade.

Port of ``dream_tpu/parallel/pipeline.py``.  Stage ``s`` of the cascade
lives on device ``s`` of the pipeline (:func:`make_pipeline_mesh`, a list
of devices; one device may repeat, so one card or the CPU can hold every
stage) and the batch streams through in ``M`` microbatches on the GPipe
tick schedule: at tick ``t`` stage ``s`` takes microbatch ``t - s``, over
``M + S - 1`` ticks, and hands its x4-upsampled maps to stage ``s + 1``
(a copy to that stage's device).  Launches on the stages' devices are
queued in tick order with no host sync inside the loop (no ``.item()``,
no ``.cpu()``), so stages on different GPUs overlap.  Where JAX runs every
stage at every tick on clamped dummy input (an SPMD program), the loop
here skips a stage's idle ticks.

As in JAX the stages are homogenised: every stage takes ``3 + n_kp``
input channels, stage 1's first conv weight zero-padded and fed zeros in
its belief slot, which changes no value.  :func:`_stack_stage_params` and
:func:`unstack_stage_params` map the sequential model's parameters to and
from the stage-stacked tree (here a list of per-stage dicts, the stage
axis being the list index), so gradients compare leaf by leaf.

Training differentiates the schedule end to end with autograd (the
backward walks the ticks in reverse and the maps' gradients flow up the
chain across the devices); ``remat`` recomputes each stage's activations
in the backward pass (``torch.utils.checkpoint``).  The loss is the
sequential all-stage criterion: every stage's maps against the target,
numerators and denominators summed over stages and microbatches
(``network.loss_terms_from_config``), so the weighted-MSE normaliser is
the whole batch's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dream_tpu_torch.models.hourglass import DreamHourglass, DreamHourglassMultiStage
from dream_tpu_torch.models.layers import upsample_nearest

_FIRST_CONV = "down1.conv0.weight"


def make_pipeline_mesh(n_stages: int, devices: Optional[Sequence[Any]] = None) -> List[torch.device]:
    """The stages' devices: ``devices[:n_stages]`` (default one GPU a
    stage).  A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass the stages' devices (e.g. "
                               "['cpu'] * n_stages)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_stages:
        raise ValueError(f"Pipeline over {n_stages} stages needs {n_stages} devices, have "
                         f"{len(devices)} (a device may be listed more than once).")
    return devices[:n_stages]


def _check_model(model: DreamHourglassMultiStage) -> DreamHourglass:
    if not isinstance(model, DreamHourglassMultiStage):
        raise ValueError(f"the pipeline takes the multistage cascade, got {type(model).__name__}")
    first = model.stage1
    if first.deconv_decoder or first.full_output:
        raise ValueError("Pipeline supports the default quarter-resolution upsample decoder.")
    if first.internalize_spatial_softmax:
        raise ValueError("Pipeline emits belief maps; decode peaks downstream.")
    return first


def _stage_module(model: DreamHourglassMultiStage, device: torch.device) -> DreamHourglass:
    """The homogenised stage: ``3 + n_kp`` input channels."""
    first = _check_model(model)
    with torch.device("meta"):
        stage = DreamHourglass(first.n_keypoints, 3 + first.n_keypoints,
                               skip_connections=first.skip_connections, dtype=first.dtype)
    return stage.to_empty(device=device).eval()


def _stack_stage_params(state: Dict[str, torch.Tensor], n_stages: int, n_keypoints: int,
                        devices: Optional[Sequence[torch.device]] = None
                        ) -> List[Dict[str, torch.Tensor]]:
    """The sequential model's parameters (``stageN.<name>``) as one dict a
    stage, stage 1's first conv weight zero-padded from 3 to ``3 +
    n_keypoints`` input channels; stage ``s`` on ``devices[s]`` where
    given."""
    stages = []
    for i in range(n_stages):
        prefix = f"stage{i + 1}."
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        if i == 0:
            k = sub[_FIRST_CONV]  # [64, 3, 3, 3]
            sub[_FIRST_CONV] = torch.cat([k, k.new_zeros((k.shape[0], n_keypoints) + k.shape[2:])], 1)
        if devices is not None:
            sub = {k: v.to(devices[i]) for k, v in sub.items()}
        stages.append(sub)
    return stages


def unstack_stage_params(stacked: Sequence[Dict[str, torch.Tensor]],
                         n_keypoints: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`_stack_stage_params`: the sequential model's
    ``stageN.<name>`` dict, the zero-pad channels cut from stage 1's first
    conv weight.  Applied to gradients this is exact: the padded input
    channels are zero, so their weights' gradients are zero."""
    params = {}
    for i, sub in enumerate(stacked):
        for name, v in sub.items():
            if i == 0 and name == _FIRST_CONV:
                v = v[:, : v.shape[1] - n_keypoints]
            params[f"stage{i + 1}.{name}"] = v
    return params


def _schedule(stage_fns: Sequence[Callable], devices: Sequence[torch.device], images: torch.Tensor,
              n_keypoints: int, n_microbatches: int, on_output: Callable[[int, int, torch.Tensor], None]
              ) -> None:
    """The GPipe tick loop.  ``images`` is NCHW float32; ``stage_fns[s](x)``
    maps a ``[mb, 3 + n_kp, H, W]`` input to the stage's float32 maps;
    ``on_output(s, m, maps)`` receives every stage's maps of every
    microbatch."""
    S, M = len(stage_fns), n_microbatches
    B, _, h, w = images.shape
    if B % M:
        raise ValueError(f"Batch {B} must divide into {M} microbatches.")
    mb = B // M
    on_device = {}
    for dev in devices:
        if dev not in on_device:
            on_device[dev] = images.to(dev, non_blocking=True)
    first_in = torch.zeros((mb, n_keypoints, h, w), dtype=images.dtype, device=devices[0])
    carry: List[Optional[torch.Tensor]] = [None] * S
    for t in range(M + S - 1):
        sent: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            img = on_device[devices[s]][m * mb:(m + 1) * mb]
            belief = stage_fns[s](torch.cat([img, first_in if s == 0 else carry[s]], dim=1))
            on_output(s, m, belief)
            if s + 1 < S:
                sent[s + 1] = upsample_nearest(belief, 4).to(images.dtype).to(
                    devices[s + 1], non_blocking=True)
        carry = sent


def pipeline_multistage_inference(model: DreamHourglassMultiStage,
                                  variables: Optional[Dict[str, torch.Tensor]] = None,
                                  mesh: Optional[Sequence[torch.device]] = None,
                                  n_microbatches: int = 4) -> Tuple[Callable, List[torch.device]]:
    """``(fn, mesh)``: ``fn(images)`` maps an NHWC float net input ``[B, H, W,
    3]`` to the final stage's float32 maps ``[B, n_kp, H/4, W/4]`` on the
    last stage's device, the cascade run as a pipeline over ``mesh``
    (:func:`make_pipeline_mesh`, default one GPU a stage).  ``variables``
    (default the model's state) is copied into the stages; ``B`` must
    divide by ``n_microbatches``."""
    first = _check_model(model)
    S, K, M = model.n_stages, first.n_keypoints, n_microbatches
    mesh = make_pipeline_mesh(S, mesh)
    state = model.state_dict() if variables is None else variables
    stacked = _stack_stage_params(state, S, K)
    stages = []
    for s, dev in enumerate(mesh):
        stage = _stage_module(model, dev)
        stage.load_state_dict(stacked[s], strict=True)
        stages.append(stage)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        outs: List[Optional[torch.Tensor]] = [None] * M

        def keep(s, m, belief):
            if s == S - 1:
                outs[m] = belief

        x = images.to(mesh[0], torch.float32).permute(0, 3, 1, 2)
        _schedule(stages, mesh, x, K, M, keep)
        return torch.cat(outs)

    return fn, mesh


def pipeline_multistage_value_and_grad(model: DreamHourglassMultiStage,
                                       variables: Optional[Dict[str, torch.Tensor]] = None,
                                       mesh: Optional[Sequence[torch.device]] = None,
                                       n_microbatches: int = 4,
                                       loss_config: Optional[Dict[str, Any]] = None,
                                       remat: bool = True):
    """``(value_and_grad_fn, stacked, mesh)``:
    ``value_and_grad_fn(stacked, images, targets) -> (loss, grads)`` with
    ``images`` the NHWC net input ``[B, H, W, 3]`` and ``targets`` the
    ``[B, n_kp, H/4, W/4]`` belief maps (the port's layout; JAX's are
    NHWC); ``loss`` is the sequential all-stage criterion of
    ``loss_config`` (``architecture.loss``; mse when None, the symmetric
    weighted MSE as the sequential criterion computes it), ``grads`` one
    dict a stage like ``stacked`` (:func:`unstack_stage_params` maps them to
    the sequential layout).  ``stacked`` holds leaf tensors on the stages'
    devices."""
    from dream_tpu_torch.network import loss_terms_from_config

    first = _check_model(model)
    S, K, M = model.n_stages, first.n_keypoints, n_microbatches
    mesh = make_pipeline_mesh(S, mesh)
    state = model.state_dict() if variables is None else variables
    stacked = [{k: v.detach().clone().requires_grad_(True) for k, v in sub.items()}
               for sub in _stack_stage_params(state, S, K, mesh)]
    stages = [_stage_module(model, dev) for dev in mesh]
    terms = loss_terms_from_config(loss_config)

    def value_and_grad_fn(params: Sequence[Dict[str, torch.Tensor]], images: torch.Tensor,
                          targets: torch.Tensor):
        B = images.shape[0]
        mb = B // M
        tgt = [targets.to(dev, torch.float32) for dev in mesh]
        nums: List[torch.Tensor] = []
        dens: List[torch.Tensor] = []

        def stage_fn(s):
            def run(x):
                return torch.func.functional_call(stages[s], params[s], (x,))

            if remat:
                return lambda x: checkpoint(run, x, use_reentrant=False)
            return run

        def accumulate(s, m, belief):
            num, den = terms(belief.to(torch.float32), tgt[s][m * mb:(m + 1) * mb])
            nums.append(num.to(mesh[-1], non_blocking=True))
            dens.append(den.to(mesh[-1], non_blocking=True))

        leaves = [v for sub in params for v in sub.values()]
        with torch.enable_grad():
            x = images.to(mesh[0], torch.float32).permute(0, 3, 1, 2)
            _schedule([stage_fn(s) for s in range(S)], mesh, x, K, M, accumulate)
            loss = torch.stack(nums).sum() / torch.stack(dens).sum()
            grads = torch.autograd.grad(loss, leaves)
        out, i = [], 0
        for sub in params:
            out.append({k: grads[i + j] for j, k in enumerate(sub)})
            i += len(sub)
        return loss.detach(), out

    return value_and_grad_fn, stacked, mesh


def pipeline_multistage_train_step(model: DreamHourglassMultiStage,
                                   variables: Optional[Dict[str, torch.Tensor]],
                                   optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                                   mesh: Optional[Sequence[torch.device]] = None,
                                   n_microbatches: int = 4,
                                   loss_config: Optional[Dict[str, Any]] = None,
                                   remat: bool = True):
    """``(step_fn, state)``: a pipelined training step, the loss and the
    reversed pipeline's gradients of :func:`pipeline_multistage_value_and_grad`
    and then the optimizer, the parameters and optimizer state resident on
    the stages' devices.  ``optimizer`` builds a torch optimizer from the
    parameter list (e.g. ``lambda p: torch.optim.Adam(p, lr=1e-4)``);
    ``state = {"params": stacked, "opt_state": that optimizer}`` and
    ``step_fn(state, images, targets) -> (state, loss)``.
    ``unstack_stage_params(state["params"], n_kp)`` gives the sequential
    layout."""
    value_and_grad_fn, stacked, mesh = pipeline_multistage_value_and_grad(
        model, variables, mesh, n_microbatches, loss_config, remat)
    opt = optimizer([v for sub in stacked for v in sub.values()])

    def step_fn(state, images, targets):
        loss, grads = value_and_grad_fn(state["params"], images, targets)
        for sub, gsub in zip(state["params"], grads):
            for k, v in sub.items():
                v.grad = gsub[k]
        state["opt_state"].step()
        state["opt_state"].zero_grad(set_to_none=True)
        return state, loss

    return step_fn, {"params": stacked, "opt_state": opt}
