"""Scanned training epochs over a set held on the device.

Set-up renders a pool of frames from the seed, tiles it into a set of ``steps
an epoch x batch`` frames on the device (every block of ``pool_frames``
positions holds the pool once, in a seeded order), makes the initial
parameters on the device from the seed (or, where the configuration names a
``training_start`` checkpoint, has the program load that file), and builds
the program's network around them with the configuration's recipe (Adam, cosine schedule, clipping,
augmentation, the EMA where the recipe keeps one) through
``DreamNetwork.enable_scanned_training``.  Its first three steps, each a
batch of the pool's frames once, run through ``train_epoch_raw``: the first
eagerly, the second captures the CUDA graph of the step, the third replays
it; what they did is read for the check.  The window then calls
``train_epoch_raw`` on slices of seeded epoch index matrices, at most two
slices in flight, until the time is up, and ends at the last slice's end.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import checks, program, render
from benchmark.harness.weights import seeded_state
from benchmark.reference import models, msgpack, train as ref_train

CHECK_STEPS = 3


def _recipe(config: dict) -> dict:
    tc = config["network"]["training"]["config"]
    opt = tc["optimizer"]
    return {"batch_size": int(tc["batch_size"]), "epochs": int(tc["epochs"]),
            "learning_rate": float(opt["learning_rate"]), "grad_clip_norm": float(opt["grad_clip_norm"]),
            "decay_steps": int(opt["schedule"]["decay_steps"]), "ema_decay": config.get("ema_decay")}


def set_up(ctx) -> dict:
    cfg, mix, device = ctx.config, ctx.traffic, ctx.device
    recipe = _recipe(cfg)
    net_config = program.network_config(cfg)
    arch = net_config["architecture"]["type"]
    n_kp = len(net_config["manipulator"]["keypoints"])
    raw_res = tuple(mix["image_raw_resolution"])
    batch = recipe["batch_size"]
    steps = recipe["decay_steps"] // recipe["epochs"]
    set_size = steps * batch

    pool = render.render_pool(program.derive(ctx.seed, 1), mix["pool_frames"], n_kp, raw_res,
                              mix["out_of_frame_fraction"], workers=ctx.workers)
    ctx.mark("render the pool")
    n_pool = len(pool["images"])
    tiles = np.random.RandomState(program.derive(ctx.seed, 2))
    order = np.concatenate([tiles.permutation(n_pool) for _ in range(-(-set_size // n_pool))])[:set_size]
    order_t = torch.from_numpy(order).to(device)
    images = torch.from_numpy(pool["images"]).to(device)[order_t]
    kps = torch.from_numpy(pool["projections"].astype(np.float32)).to(device)[order_t]
    matrices = torch.from_numpy(np.stack([
        np.random.RandomState(program.derive(ctx.seed, 3, e)).permutation(set_size).reshape(steps, batch)
        for e in range(mix["epochs_drawn"])])).to(device)

    layers = tuple(net_config["architecture"].get("layers", models.RESNET_LAYERS))
    ctx.mark("the set on the device")
    spec = models.parameter_spec(arch, n_kp, layers)
    weight_seed, gen_seed = program.derive(ctx.seed, 4), program.derive(ctx.seed, 5)
    start_file = cfg.get("training_start")
    if start_file:
        net = program.from_checkpoint(net_config, str(ctx.root / start_file), device)
    else:
        net = program.build_with_state(net_config, seeded_state(spec, weight_seed, device), device)
    net.enable_scanned_training(program.batch_processor(net, raw_res, augment=True))
    if recipe["ema_decay"]:
        net.enable_ema(float(recipe["ema_decay"]))
    generator = torch.Generator(device=device).manual_seed(gen_seed)
    ctx.mark("weights and the network")

    # The first steps, through the window's own call; each row is the pool once.
    first = torch.arange(CHECK_STEPS * batch, device=device).view(CHECK_STEPS, batch)
    named = list(net.model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    losses = [net.train_epoch_raw(generator, images, kps, first[:1])]
    state = net.optimizer.state
    # Adam's first moment after one step is a tenth of the gradient it got;
    # a step that never reached the optimizer left none.
    grads = {n: state[p]["exp_avg"] / 0.1 if "exp_avg" in state.get(p, {}) else torch.zeros_like(p)
             for n, p in named}
    grad, grad_vector = _norms(grads), torch.cat([g.flatten() for g in grads.values()])
    del grads
    losses.append(net.train_epoch_raw(generator, images, kps, first[1:]))
    prog = {"losses": torch.cat(losses).tolist(), "grad": grad, "grad_vector": grad_vector,
            "update": _norms({n: p.detach() - start[n] for n, p in named})}
    if net.ema_params is not None:
        prog["ema"] = _norms({n: net.ema_params[n] - start[n] for n, _ in named})
    del start
    ctx.mark("the first three steps, the graph captured")
    return {"net": net, "images": images, "kps": kps, "matrices": matrices, "generator": generator,
            "steps": steps, "batch": batch, "arch": arch, "n_kp": n_kp, "spec": spec, "layers": layers,
            "recipe": recipe, "raw_res": raw_res, "prog": prog, "weight_seed": weight_seed,
            "gen_seed": gen_seed, "first_frames": images[first.flatten()].clone(),
            "first_kps": kps[first.flatten()].clone(), "net_config": net_config,
            "trainable": [n for n, _ in named]}


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names]).tolist()
    return dict(zip(names, values))


def window(ctx, st: dict, seconds: float) -> dict:
    """Steps until ``seconds`` have passed; returns the counts and times."""
    net, images, kps, gen = st["net"], st["images"], st["kps"], st["generator"]
    per_call = int(ctx.traffic["steps_per_call"])
    on_card = images.is_cuda
    done, in_flight = 0, []
    t0 = time.perf_counter()
    epoch = 0
    while True:
        rows = st["matrices"][epoch % len(st["matrices"])]
        for c in range(0, st["steps"], per_call):
            chunk = rows[c:c + per_call]
            net.train_epoch_raw(gen, images, kps, chunk)
            done += chunk.shape[0]
            if on_card:
                event = torch.cuda.Event()
                event.record()
                in_flight.append(event)
                if len(in_flight) > 2:
                    in_flight.pop(0).synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        else:
            epoch += 1
            continue
        break
    if on_card:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    images_done = done * st["batch"]
    return {"attempted": done, "failed": 0, "window_s": elapsed, "images": images_done,
            "train_images_per_s": images_done / elapsed,
            "step_flops": _step_flops(st)}


def _step_flops(st: dict) -> int:
    from benchmark.harness.yardstick import train_step_flops

    netin = st["net"].trained_net_input_resolution()
    return train_step_flops(st["arch"], st["n_kp"], netin, st["batch"], st["layers"])


def release(st: dict) -> None:
    """Free the program's state: the reference runs after it, in the memory it held."""
    for key in ("net", "images", "kps", "matrices", "generator"):
        st[key] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def initial_state(ctx, st: dict) -> dict:
    """The reference's initial parameters: the same seeded draws, or the
    configuration's ``training_start`` file read by the reference's own reader."""
    start_file = ctx.config.get("training_start")
    if not start_file:
        return seeded_state(st["spec"], st["weight_seed"], ctx.device)
    tree = msgpack.read_checkpoint(str(ctx.root / start_file))
    return {k: v.to(ctx.device) for k, v in msgpack.torch_layout(tree).items()}


def reference(ctx, st: dict, precision: str = "float32") -> dict:
    """The reference's first three steps from the same weights, frames and
    draws; ``float64`` computes them in double precision, a witness of how far
    float32 itself lies from the exact steps."""
    net_config = st["net_config"]
    tc = net_config["training"]["config"]
    weights = initial_state(ctx, st)
    if precision == "float64":
        weights, precision = {k: v.double() for k, v in weights.items()}, "float32"
    if set(st["trainable"]) - set(weights):
        raise KeyError("the program has parameters the reference lacks")
    net = models.Net(st["arch"], weights, precision, st["layers"])
    out_res = models.output_resolution(st["arch"], tc["net_input_resolution"])
    trainer = ref_train.Trainer(net, st["trainable"], st["recipe"], tc["net_input_resolution"], out_res,
                                st["raw_res"], net_config["architecture"]["image_normalization"],
                                float(net_config["architecture"]["loss"]["pos_weight"]))
    start = {n: weights[n].clone() for n in st["trainable"]}
    g = torch.Generator(device=ctx.device).manual_seed(st["gen_seed"])
    b = st["batch"]
    losses, grad, grad_vector = [], None, None
    for k in range(CHECK_STEPS):
        loss, grads = trainer.step(g, st["first_frames"][k * b:(k + 1) * b], st["first_kps"][k * b:(k + 1) * b])
        losses.append(loss)
        if k == 0:
            grad = _norms(grads)
            grad_vector = torch.cat([grads[n].flatten() for n in st["trainable"]])
    ref = {"losses": losses, "grad": grad, "grad_vector": grad_vector,
           "update": _norms({n: weights[n] - start[n] for n in st["trainable"]})}
    if trainer.ema is not None:
        ref["ema"] = _norms({n: trainer.ema[n] - start[n] for n in st["trainable"]})
    return ref


def check(ctx, st: dict) -> dict:
    release(st)
    with models.exact_float32():
        ref = reference(ctx, st)
    return checks.train_numbers(st["prog"], ref)
