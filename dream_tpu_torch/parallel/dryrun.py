"""Training on a mesh of local ranks, and the multi-GPU dry run.

- :func:`mesh_train_run`: one rank's part of training runs on a
  ``(data, model)`` mesh (``DreamNetwork.shard_for_mesh``), each run a dict
  naming the network and the global batches; it returns what a check
  compares with a one-rank run: the losses, the parameters and buffers
  gathered whole, the first step's gradients, the kernel launches and the
  step times.  Rank functions for :func:`~.mesh.spawn_local_ranks`.
- :func:`dryrun_multichip`: the counterpart of ``dream_tpu``'s
  ``__graft_entry__.dryrun_multichip`` (``:24-173``): one data- (and, with
  at least 4 even ranks, model-) parallel train step of a 2-stage cascade
  at 64x64 with 4 keypoints, asserting that a conv is split over the model
  axis; the sharded inference; then one pipelined train step over 2 stages.
- :func:`split_gradient_reading`: where a channel-split step's float32
  gradients part from the unsharded step's, leaf by leaf against float64,
  with the discrete choices of each forward (each conv output's sign, which
  the ReLU after it reads, and each 2x2 max-pool's pick;
  :func:`record_decisions`) counted where two runs part
  (``scripts/split_gradient_layers.py``, ``chip_smoke.py`` phase 32).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dream_tpu_torch.ops import kernel_launches
from dream_tpu_torch.parallel import mesh as mesh_ops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_float64(net) -> None:
    """Put ``net``'s parameters, buffers and every module's compute dtype in
    float64, and make its optimizer anew: a witness for checks, where a
    mesh's step must equal one rank's to float64's rounding.  The maps
    still leave the head in float32, and BatchNorm's batch statistics stay
    float32 (``models/layers.py``)."""
    net.model.double()
    for module in net.model.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(module, attr, None), torch.dtype):
                setattr(module, attr, torch.float64)
    net.optimizer = None
    net.enable_training()


def record_decisions(model: torch.nn.Module, rows: int, layers: Sequence[str] = ()
                     ) -> Tuple[Dict[str, np.ndarray], Callable]:
    """Forward hooks on ``model`` that record, for the first ``rows`` rows
    of its next forward, the sign of every conv's output (packed bits;
    gathered whole on a mesh, since the hooks go on after the split hooks)
    and, for each VGG down block the hourglass pools (``down1``-``down4``),
    the window position its 2x2 max-pool picks; with ``layers``, only for
    the modules whose names start with one of them.  Returns ``(records,
    remove)``; call ``remove()`` after that forward."""
    records: Dict[str, np.ndarray] = {}

    def keep(name, pooled):
        def hook(module, args, output):
            if name in records:
                return
            out = output[:rows].detach()
            if pooled:
                _, index = F.max_pool2d(out, 2, 2, return_indices=True)
                w = out.shape[-1]
                row, col = index // w, index % w
                records[name] = ((row % 2) * 2 + col % 2).to(torch.uint8).cpu().numpy()
            else:
                records[name] = np.packbits((out > 0).cpu().numpy())
        return hook

    handles = []
    for name, module in model.named_modules():
        if layers and not name.startswith(tuple(layers)):
            continue
        if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            handles.append(module.register_forward_hook(keep(name, False)))
        elif name.split(".")[-1] in ("down1", "down2", "down3", "down4"):
            handles.append(module.register_forward_hook(keep(name + ".pool", True)))

    def remove():
        for h in handles:
            h.remove()

    return records, remove


def decision_flips(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, List[int]]:
    """Per recorded layer, ``[decisions that differ, decisions]`` between two
    runs' :func:`record_decisions`."""
    out = {}
    for name, x in a.items():
        y = b[name]
        if name.endswith(".pool"):
            out[name] = [int(np.sum(x != y)), int(x.size)]
        else:
            out[name] = [int(np.unpackbits(x ^ y).sum()), int(x.size * 8)]
    return out


def gradient_gaps(grads: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per parameter leaf, the relative L2 distance of ``grads`` from
    ``reference`` (NaN where the reference leaf is zero)."""
    out = {}
    for name, g in reference.items():
        norm = float(g.double().norm())
        out[name] = float((grads[name].double() - g.double()).norm()) / norm if norm > 0 else math.nan
    return out


def whole_gap(grads: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> float:
    """Relative L2 distance of all the leaves laid end to end."""
    num = sum(float((grads[k].double() - g.double()).square().sum()) for k, g in reference.items())
    return math.sqrt(num / sum(float(g.double().square().sum()) for g in reference.values()))


def split_gradient_reading(unsharded32: Dict[str, Any], unsharded64: Dict[str, Any],
                           split32: Dict[str, Any], split64: Dict[str, Any]) -> Dict[str, Any]:
    """The per-layer reading of four :func:`train_steps` records of one
    step (unsharded and split, float32 and float64, each with
    ``decisions``): the whole gradients' distances; each leaf's float32
    distance from the unsharded float64 step, unsharded and split, from the
    head back to the input (the order the backward runs), and the leaf
    where the split one's ratio to the unsharded one's peaks (``entry``);
    the decisions that part between runs, per recorded layer."""
    ref = unsharded64["grads"]
    unsharded, split = gradient_gaps(unsharded32["grads"], ref), gradient_gaps(split32["grads"], ref)
    leaves = [[k, unsharded[k], split[k]] for k in list(ref)[::-1]]
    pairs = {"split32_vs_unsharded32": (split32, unsharded32), "unsharded32_vs_float64": (unsharded32, unsharded64),
             "split32_vs_float64": (split32, unsharded64), "split64_vs_float64": (split64, unsharded64)}
    flips = {pair: decision_flips(a["decisions"], b["decisions"]) for pair, (a, b) in pairs.items()}
    return {
        "whole": {"unsharded_float32": whole_gap(unsharded32["grads"], ref),
                  "split_float32": whole_gap(split32["grads"], ref),
                  "split_vs_unsharded_float32": whole_gap(split32["grads"], unsharded32["grads"]),
                  "split_float64": whole_gap(split64["grads"], ref)},
        "split_leaves": split32["split"],
        "leaves": leaves,
        "entry": max(leaves, key=lambda leaf: leaf[2] / leaf[1] if leaf[1] > 0 else 0.0),
        "decisions": {layer: {pair: flips[pair][layer] for pair in flips}
                      for layer in unsharded64["decisions"]},
    }


def train_network_for_run(run: Dict[str, Any], device: Any, mesh=None):
    """The network a run names: ``run["config"]`` (a loaded config dict),
    its parameters from ``run["params_path"]`` (flax msgpack) or drawn from
    ``run["seed"]``, in float64 with ``run["float64"]`` (:func:`to_float64`),
    training enabled, sharded on ``mesh`` when given."""
    import copy

    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.network import DreamNetwork

    net = DreamNetwork(copy.deepcopy(run["config"]), device=device, seed=run.get("seed", 0))
    if run.get("params_path"):
        net.load_network_params(run["params_path"])
    tcfg = net.network_config["training"]["config"]
    net.enable_fused_training(make_batch_processor(
        tuple(tcfg["image_raw_resolution"]), net.trained_net_input_resolution(),
        net.trained_net_output_resolution(), net.image_preprocessing(), net.image_normalization,
        augment=run.get("augment", False)))
    if run.get("float64"):
        to_float64(net)
    if mesh is not None:
        net.shard_for_mesh(mesh)
    return net


def train_steps(net, run: Dict[str, Any]) -> Dict[str, Any]:
    """``run["steps"]`` steps of ``net`` on the run's global batch
    (``run["batch"]``: ``{"raw", "kp"}`` frames for ``train_raw``, its
    augmentation seeded by ``run["aug_seed"]``, or ``{"x", "target"}`` for
    ``train``; with ``run["local"]`` on a mesh, each rank passes its own
    rows, ``local=True``).  Returns the losses and step times, the first
    step's gradients and BatchNorm running statistics, the state after the
    last step, whole, and for unaugmented frames the evaluation loss of the
    batch before the first step; with ``run["record_decisions"]`` (a row
    count; ``run["record_layers"]`` names the layers, default all), the
    first step's :func:`record_decisions` as ``decisions``."""
    batch = {k: torch.as_tensor(v) for k, v in run["batch"].items()}
    local = bool(run.get("local")) and net._mesh is not None
    if local:
        batch = {k: mesh_ops.process_local_batch(net._mesh, v) for k, v in batch.items()}
    eval_loss = None
    if "raw" in batch and not run.get("augment"):
        frames = net._batch_processor(None, batch["raw"].to(net.device), batch["kp"].to(net.device))
        eval_loss = float(net.loss([frames["image_rgb_input"]], frames["belief_maps"], local=local))
    generator = torch.Generator(device=net.device).manual_seed(run.get("aug_seed", 0))
    start = kernel_launches()
    losses, step_ms, grads = [], [], None
    decisions, stop_recording = (record_decisions(net.model, run["record_decisions"], run.get("record_layers", ()))
                                 if run.get("record_decisions") else (None, None))
    for step in range(run["steps"]):
        _sync(net.device)
        t0 = time.perf_counter()
        if "raw" in batch:
            loss = net.train_raw(generator, batch["raw"], batch["kp"], local)
        else:
            loss = net.train([batch["x"]], batch["target"], local)
        if step == 0 and stop_recording is not None:
            stop_recording()
        losses.append(float(loss))
        _sync(net.device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            grads = net.full_state({n: p.grad for n, p in net.model.named_parameters()})
            running = {k: v.detach().cpu().clone() for k, v in net.model.state_dict().items()
                       if "running_" in k}
    launches = {k: v - start[k] for k, v in kernel_launches().items()}
    out = {"losses": losses, "step_ms": step_ms, "split": sorted(net._split),
           "state": {k: v.detach().cpu().clone() for k, v in net.full_state().items()},
           "grads": {k: v.detach().cpu().clone() for k, v in grads.items()},
           "running_after_first_step": running, "launches": launches}
    if eval_loss is not None:
        out["eval_loss"] = eval_loss
    if decisions is not None:
        out["decisions"] = decisions
    return out


def mesh_train_run(rank: int, runs: Sequence[Dict[str, Any]], devices: Sequence[str]
                   ) -> List[Dict[str, Any]]:
    """Rank ``rank``'s part of each run, on the run's ``(n_data,
    n_model)`` mesh of the process group, on ``devices[rank]``; returns each
    run's :func:`train_steps` record (the same on every rank)."""
    out = []
    for run in runs:
        mesh = mesh_ops.make_mesh(run["n_data"], run["n_model"], devices)
        net = train_network_for_run(run, mesh.device, mesh)
        out.append(train_steps(net, run))
        del net
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _dryrun_rank(rank: int, n_devices: int, devices: Sequence[str]) -> Dict[str, Any]:
    from dream_tpu_torch.models.hourglass import DreamHourglassMultiStage
    from dream_tpu_torch.ops.belief_maps import create_belief_maps, keypoints_from_belief_maps

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = mesh_ops.make_mesh(n_devices // n_model, n_model, devices)
    device = mesh.device
    model = DreamHourglassMultiStage(4, 2, generator=torch.Generator().manual_seed(0)).to(device)
    batch = 2 * mesh.shape["data"]
    x = torch.zeros((batch, 64, 64, 3), device=device)
    kp = torch.tensor([[4.0, 4.0], [10.0, 4.0], [4.0, 10.0], [9.0, 9.0]], device=device)
    target = create_belief_maps(kp.expand(batch, 4, 2), (16, 16))
    full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    split = mesh_ops.shard_params(model, mesh)
    if n_model > 1:
        if not split:
            raise AssertionError("model axis > 1 but no conv weight is split over it")
        name = next(n for n in split if n.endswith("weight"))
        shard = tuple(model.get_parameter(name).shape)
        if shard[0] != full_shapes[name][0] // n_model:
            raise AssertionError(f"weight {full_shapes[name]} shard {shard} is not split over "
                                 "the model axis")
    opt = torch.optim.Adam(model.parameters(), 1e-4)
    rows = mesh.rows(batch)
    model.train()
    outs = torch.stack(model(x[rows].permute(0, 3, 1, 2)))
    num = torch.sum((outs - target[rows]) ** 2)
    objective, loss = mesh_ops.global_loss(num, torch.tensor(float(outs.numel()), device=device), mesh)
    objective.backward()
    mesh_ops.reduce_gradients(list(model.parameters()), mesh)
    opt.step()
    loss_val = float(loss)
    if loss_val != loss_val:
        raise AssertionError("loss is NaN")
    # The sharded inference: forward and peak decode of the whole batch.
    model.eval()
    with torch.no_grad():
        kps, _ = keypoints_from_belief_maps(model(x.permute(0, 3, 1, 2))[-1], 0.4395)
    if tuple(kps.shape) != (batch, 4, 2):
        raise AssertionError(f"keypoints {tuple(kps.shape)}")
    return {"mesh": dict(mesh.shape), "loss": loss_val, "kps": tuple(kps.shape),
            "split": len(split), "launches": kernel_launches()}


def dryrun_multichip(n_devices: int, device: Any = "cuda", backend: str = "nccl") -> Dict[str, Any]:
    """Spawn ``n_devices`` ranks (under NCCL one GPU each; under gloo all on
    ``device``) and run one data- and model-parallel train step and the
    sharded inference (:func:`_dryrun_rank`); then, in this process, one
    pipelined train step of the cascade over two stages on ``device``.
    Prints a line as ``dream_tpu``'s and returns the ranks' records and the
    pipeline's loss."""
    from dream_tpu_torch.models.hourglass import DreamHourglassMultiStage
    from dream_tpu_torch.ops.belief_maps import create_belief_maps
    from dream_tpu_torch.parallel.pipeline import make_pipeline_mesh, pipeline_multistage_train_step

    devices = mesh_ops.rank_devices(n_devices, device, backend)
    ranks = mesh_ops.spawn_local_ranks(_dryrun_rank, n_devices, backend, devices, n_devices,
                                       devices)
    pipe_loss_val = None
    if n_devices >= 2:
        dev = torch.device(devices[0])
        model = DreamHourglassMultiStage(4, 2, generator=torch.Generator().manual_seed(1)).to(dev)
        x = torch.zeros((4, 64, 64, 3), device=dev)
        kp = torch.tensor([[4.0, 4.0], [10.0, 4.0], [4.0, 10.0], [9.0, 9.0]], device=dev)
        target = create_belief_maps(kp.expand(4, 4, 2), (16, 16))
        step, state = pipeline_multistage_train_step(
            model, None, lambda p: torch.optim.Adam(p, 1e-4), make_pipeline_mesh(2, [dev, dev]),
            n_microbatches=2, loss_config={"type": "mse"})
        state, pipe_loss = step(state, x, target)
        pipe_loss_val = float(pipe_loss)
        if pipe_loss_val != pipe_loss_val:
            raise AssertionError("pipeline loss is NaN")
    first = ranks[0]
    print(f"dryrun_multichip OK: mesh={first['mesh']} loss={first['loss']:.6f} "
          f"kps={first['kps']} pipeline_loss={pipe_loss_val}", flush=True)
    return {"ranks": ranks, "pipeline_loss": pipe_loss_val}
