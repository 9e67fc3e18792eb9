"""Train a DREAM network on an NDDS dataset, with checkpoints and resume.

The port's ``scripts/train_network.py``: the same flags, config assembly,
checkpoint layout and resume semantics, on one device.

- The host decodes frames (:class:`~dream_tpu_torch.data.dataset.DataLoader`,
  a prefetch thread), or ``--cache-device`` decodes the set once and keeps it
  on the card; preprocessing, augmentation (the CUDA warp kernel), belief
  maps, forward and backward run on the device in ``train_raw``.
- Checkpoints in ``-o``: ``epoch_N.{yaml,msgpack,opt.msgpack,ema.msgpack}``
  (earlier epochs deleted), ``best_network.*``, ``best_network_ema.*`` and
  ``training_log_eN.pkl``, renamed ``training_log.pkl`` at the end.  The
  ``.msgpack`` files are flax msgpack and ``.opt.msgpack`` holds the optax
  state tree, so either package resumes the other's run.  The trees are
  host copies taken at the end of the epoch; the files are written on a
  background thread, at most one write in flight.
- ``-r`` resumes from the newest ``epoch_N`` with its parameters, optimizer
  state, schedule position and EMA, and the logged seed (the same split).

``--mesh-data``/``--mesh-model`` above 1 and ``--distributed`` (with its
coordinator and process flags) belong to the multi-GPU slice, which the
port has not yet; they raise.

Example (the r5 vgg-Q recipe):
  python3 -m dream_tpu_torch.cli.train_network -i _scratch/d768 \\
      -m manip_configs/panda.yaml -ar arch_configs/dream_vgg_q.yaml -o _scratch/vggq \\
      -e 300 -b 32 -lr 2e-4 --grad-clip-norm 1.0 --cache-device --compute-dtype bfloat16 \\
      --loss-pos-weight 50 --ema-decay 0.999 -s 42
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import os
import pickle
import random
import socket
import time

import numpy as np
import torch

from dream_tpu_torch.checkpoint import (
    load_flax_checkpoint,
    params_from_flax,
    save_flax_checkpoint,
    state_to_flax,
)
from dream_tpu_torch.data import dataset as dream_data
from dream_tpu_torch.network import KNOWN_OPTIMIZERS, DreamNetwork, resolve_device
from dream_tpu_torch.utils.config import load_yaml, save_yaml
from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, load_image_resolution

STALE_SUFFIXES = (".yaml", ".msgpack", ".opt.msgpack", ".ema.msgpack")


def _write_checkpoint(output_dir, stem, config, variables, opt_state=None,
                      delete_stale_before=None, ema_variables=None):
    """Disk half of a checkpoint (runs on the writer thread); the trees are
    host snapshots."""
    save_yaml(config, os.path.join(output_dir, stem + ".yaml"), overwrite=True)
    save_flax_checkpoint(os.path.join(output_dir, stem + ".msgpack"), variables)
    if opt_state is not None:
        save_flax_checkpoint(os.path.join(output_dir, stem + ".opt.msgpack"), opt_state)
    if ema_variables is not None:
        # The whole variables tree with the EMA parameters in it: loadable
        # by every evaluation entry point like any checkpoint.
        save_flax_checkpoint(os.path.join(output_dir, stem + ".ema.msgpack"), ema_variables)
    if delete_stale_before is not None:
        for old_epoch in range(1, delete_stale_before):
            for suffix in STALE_SUFFIXES:
                stale = os.path.join(output_dir, f"epoch_{old_epoch}{suffix}")
                if os.path.exists(stale):
                    os.remove(stale)


class AsyncCheckpointWriter:
    """Checkpoint writes on one background thread, at most one in flight: a
    second submit first waits for the first, so checkpoints never fall more
    than one write behind training.  :meth:`wait` raises what a write
    raised."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._future = None

    def submit(self, fn, *fn_args):
        self.wait()
        self._future = self._pool.submit(fn, *fn_args)

    def wait(self):
        if self._future is not None:
            future, self._future = self._future, None
            future.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._pool.shutdown()


def _set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _unported_flags(args) -> list:
    flags = []
    if args.mesh_data * args.mesh_model > 1:
        flags.append("--mesh-data/--mesh-model above 1")
    if args.distributed or args.coordinator_address or args.num_processes or args.process_id is not None:
        flags.append("--distributed and its coordinator/process flags")
    return flags


def train_network(args):
    if args.epochs <= 0 or args.batch_size <= 0:
        raise ValueError("--epochs and --batch-size must be positive")
    if not 0.0 < args.training_data_fraction < 1.0:
        raise ValueError("--training-data-fraction must lie in (0, 1)")
    unported = _unported_flags(args)
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: multi-GPU training is not ported yet (ROADMAP.md section 1, "
            "item 'Multi-GPU')"
        )
    device = resolve_device(args.device)
    validation_data_fraction = 1.0 - args.training_data_fraction

    if args.output_dir:
        save_results = True
        if not args.resume_training:
            if os.path.exists(args.output_dir) and not args.force_overwrite:
                raise FileExistsError(f'Specified directory "{args.output_dir}" already exists.')
            os.makedirs(args.output_dir, exist_ok=True)
    else:
        if args.resume_training:
            raise ValueError("Cannot resume training; output directory not provided.")
        save_results = False

    training_start_time = time.time()

    # Resume scan.
    start_epoch = 0
    most_recent_epoch_params_path = None
    if args.resume_training:
        epoch_paths = [x for x in os.listdir(args.output_dir)
                       if x.startswith("epoch") and x.endswith(".msgpack")
                       and ".opt." not in x and ".ema." not in x]
        if not epoch_paths:
            raise FileNotFoundError("No epoch checkpoints found to resume from.")
        epoch_numbers = [int(p.split("_")[1].split(".")[0]) for p in epoch_paths]
        newest = int(np.argmax(epoch_numbers))
        most_recent_epoch_params_path = epoch_paths[newest]
        start_epoch = epoch_numbers[newest]
        if start_epoch >= args.epochs:
            raise ValueError("Network is already trained for the number of requested epochs.")
        best_path = os.path.join(args.output_dir, "best_network.yaml")
        if not os.path.exists(best_path):
            raise FileNotFoundError("Could not determine the best validation loss.")
        best_valid_loss = load_yaml(best_path)["training"]["results"]["validation_loss"]["mean"]

        log_path = os.path.join(args.output_dir, "training_log.pkl")
        epoch_log_path = os.path.join(args.output_dir, f"training_log_e{start_epoch}.pkl")
        if os.path.exists(log_path):
            with open(log_path, "rb") as f:
                train_log = pickle.load(f)
            os.rename(log_path, epoch_log_path)
        elif os.path.exists(epoch_log_path):
            with open(epoch_log_path, "rb") as f:
                train_log = pickle.load(f)
        else:
            raise FileNotFoundError("Could not determine training log file to resume.")
        random_seed = train_log["random_seed"]
        if not isinstance(train_log["start_time"], list):
            train_log["start_time"] = [train_log["start_time"]]
        train_log["start_time"].append(training_start_time)
        train_log.setdefault("epochs_resumed", []).append(start_epoch + 1)
    else:
        random_seed = args.random_seed if args.random_seed else random.randint(0, 999999)
        train_log = {
            "epochs": [],
            "losses": [],
            "validation_losses": [],
            "batch_training_losses": [],
            "batch_validation_losses": [],
            "batch_training_sample_names": [],
            "batch_validation_sample_names": [],
            "start_time": training_start_time,
            "timestamps": [],
            "random_seed": random_seed,
        }
        best_valid_loss = float("inf")
    # Best-EMA tracking restarts on resume (its loss is not in the config).
    best_ema_valid_loss = float("inf")

    _set_random_seed(random_seed)
    enable_augment_data = not args.not_augment_data

    # Config assembly.
    input_data_path = args.input_data_path
    found_data = find_ndds_data_in_dir(input_data_path)
    image_raw_resolution = load_image_resolution(found_data[1]["camera"])
    manipulator_config = load_yaml(args.manipulator_config_path)["manipulator"]
    architecture_config_file = load_yaml(args.architecture_config)
    architecture_config = architecture_config_file["architecture"]
    training_config_in = architecture_config_file["training"]["config"]

    # image_preprocessing may live in either place.
    training_image_preprocessing = training_config_in.get(
        "image_preprocessing", architecture_config.get("image_preprocessing"))
    if not training_image_preprocessing:
        raise ValueError('Expected "image_preprocessing" in the architecture or training config.')
    if "image_preprocessing" in architecture_config:
        if architecture_config["image_preprocessing"] != training_image_preprocessing:
            raise ValueError("The architecture and training configs disagree on image_preprocessing.")
    else:
        architecture_config["image_preprocessing"] = training_image_preprocessing
    training_net_input_resolution = training_config_in["net_input_resolution"]

    if args.loss_pos_weight is not None:
        architecture_config["loss"] = {"type": "weighted_mse", "pos_weight": args.loss_pos_weight}
        if args.loss_sym:
            architecture_config["loss"]["symmetric"] = True
    if args.compute_dtype:
        architecture_config["compute_dtype"] = args.compute_dtype
    if args.quant_mode:
        architecture_config["quant_mode"] = args.quant_mode

    try:
        user = os.getlogin()
    except OSError:
        user = "not found"

    optimizer_config = {"type": args.optimizer, "learning_rate": args.learning_rate}
    if args.grad_clip_norm:
        optimizer_config["grad_clip_norm"] = args.grad_clip_norm
    if args.lr_decay_steps:
        optimizer_config["schedule"] = {"type": "cosine", "decay_steps": args.lr_decay_steps,
                                        "warmup_steps": args.lr_warmup_steps}
    network_config = {
        "data_path": input_data_path,
        "manipulator": manipulator_config,
        "architecture": architecture_config,
        "training": {
            "config": {
                "epochs": args.epochs,
                "training_data_fraction": args.training_data_fraction,
                "validation_data_fraction": validation_data_fraction,
                "batch_size": args.batch_size,
                "data_augmentation": {"image_rgb": True} if enable_augment_data else False,
                "worker_size": args.num_workers,
                "optimizer": optimizer_config,
                "image_preprocessing": training_image_preprocessing,
                "image_raw_resolution": list(image_raw_resolution),
                "net_input_resolution": training_net_input_resolution,
            },
            "platform": {
                "user": user,
                "hostname": socket.gethostname(),
                "mesh": {"data": args.mesh_data, "model": args.mesh_model},
                "n_devices": torch.cuda.device_count() if device.type == "cuda" else 1,
                "backend": device.type,
            },
            "results": {"epochs_trained": 0},
        },
    }

    # Resume consistency checks.
    if args.resume_training:
        prev = load_yaml(os.path.join(args.output_dir,
                                      most_recent_epoch_params_path.replace(".msgpack", ".yaml")))
        for key in ("data_path", "manipulator", "architecture"):
            if prev[key] != network_config[key]:
                raise ValueError(f"Resumed run's {key} differs from the checkpoint's")
        for k in ["training_data_fraction", "validation_data_fraction", "batch_size",
                  "data_augmentation", "worker_size", "optimizer", "image_preprocessing",
                  "image_raw_resolution", "net_input_resolution"]:
            if prev["training"]["config"][k] != network_config["training"]["config"][k]:
                raise ValueError(f"Resumed run's training config {k} differs from the checkpoint's")
        network_config = prev
        print(f"~~ RESUMING TRAINING FROM {most_recent_epoch_params_path} ~~\n")

    print(f"Network configuration: {network_config}")
    dream_network = DreamNetwork(network_config, device=device, seed=random_seed)
    if args.resume_training:
        dream_network.load_network_params(os.path.join(args.output_dir, most_recent_epoch_params_path))
    elif args.init_params:
        dream_network.load_network_params(args.init_params)
        print(f"Initialized parameters from {args.init_params}")
    elif args.init_encoder:
        n_grafted, n_skipped = dream_network.init_encoder_from(args.init_encoder)
        print(f"Initialized encoder from {args.init_encoder} "
              f"({n_grafted} leaves grafted, {n_skipped} shape-skipped)")
    dream_network.enable_training()
    if args.resume_training:
        opt_path = os.path.join(args.output_dir,
                                most_recent_epoch_params_path.replace(".msgpack", ".opt.msgpack"))
        if os.path.exists(opt_path):
            dream_network.load_optimizer_state(load_flax_checkpoint(opt_path))
            print("Restored optimizer state.")

    trained_net_input_res, trained_net_output_res = (
        dream_network.net_resolutions_from_image_raw_resolution(image_raw_resolution))
    if dream_network.trained_net_input_resolution() != tuple(trained_net_input_res):
        raise ValueError("The dataset's frames do not give the network's trained input resolution.")
    dream_network.network_config["training"]["config"]["net_output_resolution"] = list(
        trained_net_output_res)

    # Dataset, loaders and the device-side batch processors.
    dataset = dream_data.ManipulatorNDDSDataset(
        found_data, manipulator_config["name"], dream_network.keypoint_names,
        trained_net_input_res, trained_net_output_res, dream_network.image_normalization,
        dream_network.image_preprocessing(), augment_data=enable_augment_data,
        include_ground_truth=True, include_belief_maps=True,
        n_decode_threads=max(args.num_workers, 1),
    )
    train_idx, valid_idx = dream_data.split_indices(len(dataset), args.training_data_fraction,
                                                    random_seed)
    if args.cache_device:
        def make_loader(**kwargs):
            return dream_data.DeviceCachedLoader(dataset, args.batch_size, seed=random_seed,
                                                 device=device, **kwargs)
    else:
        def make_loader(**kwargs):
            return dream_data.DataLoader(dataset, args.batch_size, seed=random_seed, **kwargs)
    train_loader = make_loader(shuffle=True, indices=train_idx)
    valid_loader = make_loader(shuffle=False, indices=valid_idx, drop_last=False)

    processor_args = (image_raw_resolution, trained_net_input_res, trained_net_output_res,
                      dream_network.image_preprocessing(), dream_network.image_normalization)
    dream_network.enable_fused_training(
        dream_data.make_batch_processor(*processor_args, augment=enable_augment_data))
    process_valid = dream_data.make_batch_processor(*processor_args, augment=False)
    if args.ema_decay is not None:
        dream_network.enable_ema(args.ema_decay)
        if args.resume_training:
            ema_path = os.path.join(args.output_dir,
                                    most_recent_epoch_params_path.replace(".msgpack", ".ema.msgpack"))
            if os.path.exists(ema_path):
                ema = params_from_flax(load_flax_checkpoint(ema_path))
                for name, e in dream_network.ema_params.items():
                    e.copy_(ema[name])
                print("Restored EMA parameters.")
        print(f"Parameter EMA enabled (decay {args.ema_decay}).")

    generator = torch.Generator(device=device).manual_seed(random_seed)
    writer = AsyncCheckpointWriter()
    epoch_training_log_path = None

    print("\nTRAINING NETWORK ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~\n")
    last_epoch_timestamp = 0.0
    try:
        for e in range(start_epoch, args.epochs):
            this_epoch = e + 1
            print(f"Epoch {this_epoch} ------------")
            # A trace of the run's second epoch, the first in steady state.
            profiler = None
            if args.profile_dir and e == start_epoch + 1:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])])
                profiler.start()

            train_loader.set_epoch(e)
            if args.cache_device:
                index_matrix = train_loader.epoch_index_matrix(e)
                losses_t = dream_network.train_epoch_raw(
                    generator, train_loader.device_images, train_loader.device_kp_projs, index_matrix)
                training_batch_sample_names = [dataset.sample_names(train_loader.indices[sel])
                                               for sel in index_matrix]
            else:
                step_losses, training_batch_sample_names = [], []
                for batch_idx, host_batch in enumerate(train_loader):
                    loss = dream_network.train_raw(
                        generator, torch.as_tensor(host_batch["image_rgb_raw"]).to(device),
                        torch.as_tensor(host_batch["keypoint_projections_raw"]).to(device))
                    # The loss stays on the device; one transfer an epoch.
                    step_losses.append(loss)
                    training_batch_sample_names.append(dataset.sample_names(host_batch["indices"]))
                    if args.verbose:
                        print(f"  batch {batch_idx}: loss {float(loss):.6f}")
                losses_t = torch.stack(step_losses) if step_losses else torch.zeros(0)
            training_batch_losses = [float(x) for x in losses_t.cpu()]
            mean_training_loss = float(np.mean(training_batch_losses))
            std_training_loss = float(np.std(training_batch_losses))

            # Validation (--valid-every thins it; the last epoch always runs it).
            run_validation = this_epoch % args.valid_every == 0 or this_epoch == args.epochs
            valid_batch_losses, valid_batch_sample_names = [], []
            mean_ema_valid_loss = float("nan")
            if run_validation:
                ema_vars = dream_network.ema_variables() if args.ema_decay is not None else None
                vlosses, ema_losses = [], []
                for host_batch in valid_loader:
                    batch = process_valid(
                        None, torch.as_tensor(host_batch["image_rgb_raw"]).to(device),
                        torch.as_tensor(host_batch["keypoint_projections_raw"]).to(device))
                    heads, target = [batch["image_rgb_input"]], batch["belief_maps"]
                    vlosses.append(dream_network.loss(heads, target))
                    if ema_vars is not None:
                        ema_losses.append(dream_network.loss(heads, target, variables=ema_vars))
                    valid_batch_sample_names.append(dataset.sample_names(host_batch["indices"]))
                valid_batch_losses = [float(x) for x in vlosses]
                mean_valid_loss = float(np.mean(valid_batch_losses))
                std_valid_loss = float(np.std(valid_batch_losses))
                if ema_losses:
                    mean_ema_valid_loss = float(np.mean([float(x) for x in ema_losses]))
            else:
                mean_valid_loss = std_valid_loss = float("nan")

            results = dream_network.network_config["training"]["results"]
            results["epochs_trained"] += 1
            results["training_loss"] = {"mean": mean_training_loss, "stdev": std_training_loss}
            if run_validation:
                results["validation_loss"] = {"mean": mean_valid_loss, "stdev": std_valid_loss}
            print(f"Training Loss (batch-wise mean +- 1 stdev): "
                  f"{mean_training_loss} +- {std_training_loss}")
            if run_validation:
                print(f"Validation Loss (batch-wise mean +- 1 stdev): "
                      f"{mean_valid_loss} +- {std_valid_loss}")

            if run_validation and mean_valid_loss < best_valid_loss:
                print("Best network result so far.")
                best_valid_loss = mean_valid_loss
                if save_results:
                    writer.submit(_write_checkpoint, args.output_dir, "best_network",
                                  copy.deepcopy(dream_network.network_config),
                                  state_to_flax(dream_network.model.state_dict()))
            if run_validation and args.ema_decay is not None:
                print(f"EMA Validation Loss (batch-wise mean): {mean_ema_valid_loss}")
                if mean_ema_valid_loss < best_ema_valid_loss:
                    print("Best EMA network result so far.")
                    best_ema_valid_loss = mean_ema_valid_loss
                    if save_results:
                        writer.submit(_write_checkpoint, args.output_dir, "best_network_ema",
                                      copy.deepcopy(dream_network.network_config),
                                      state_to_flax(dream_network.ema_variables()))

            if profiler is not None:
                profiler.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                trace = os.path.join(args.profile_dir, f"epoch_{this_epoch}.trace.json")
                profiler.export_chrome_trace(trace)
                print(f"Wrote device trace to {trace}")

            this_epoch_timestamp = time.time() - training_start_time
            print(f"This epoch took {this_epoch_timestamp - last_epoch_timestamp} seconds.\n")
            last_epoch_timestamp = this_epoch_timestamp

            train_log["epochs"].append(this_epoch)
            train_log["losses"].append(mean_training_loss)
            train_log["validation_losses"].append(mean_valid_loss)
            train_log["batch_training_losses"].append(training_batch_losses)
            train_log["batch_validation_losses"].append(valid_batch_losses)
            train_log["batch_training_sample_names"].append(training_batch_sample_names)
            train_log["batch_validation_sample_names"].append(valid_batch_sample_names)
            train_log["timestamps"].append(this_epoch_timestamp)

            if save_results:
                epoch_training_log_path = os.path.join(args.output_dir,
                                                       f"training_log_e{this_epoch}.pkl")
                with open(epoch_training_log_path, "wb") as f:
                    pickle.dump(train_log, f)
                last_log = os.path.join(args.output_dir, f"training_log_e{e}.pkl")
                if os.path.exists(last_log):
                    os.remove(last_log)
                if this_epoch % args.checkpoint_every == 0 or this_epoch == args.epochs:
                    writer.submit(
                        _write_checkpoint, args.output_dir, f"epoch_{this_epoch}",
                        copy.deepcopy(dream_network.network_config),
                        state_to_flax(dream_network.model.state_dict()),
                        dream_network.optimizer_state(), this_epoch,
                        state_to_flax(dream_network.ema_variables())
                        if args.ema_decay is not None else None,
                    )
    finally:
        writer.close()
    if save_results:
        os.rename(epoch_training_log_path, os.path.join(args.output_dir, "training_log.pkl"))

    print("~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~\n")
    print("Done.\n")
    print(f"Total training time: {time.time() - training_start_time} seconds.\n")
    return dream_network


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-data-path", required=True, help="Path to training data.")
    parser.add_argument("-t", "--training-data-fraction", type=float, default=0.8)
    parser.add_argument("-m", "--manipulator-config-path", required=True)
    parser.add_argument("-o", "--output-dir")
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    parser.add_argument("-ar", "--architecture-config", required=True)
    parser.add_argument("-e", "--epochs", type=int, required=True)
    parser.add_argument("-b", "--batch-size", type=int, required=True)
    parser.add_argument("-z", "--optimizer", choices=KNOWN_OPTIMIZERS, default="adam")
    parser.add_argument("-lr", "--learning-rate", type=float, default=0.0001)
    parser.add_argument("-not-a", "--not-augment-data", action="store_true", default=False)
    parser.add_argument("-w", "--num-workers", type=int, default=8, help="Host image-decode threads.")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="Data-parallel axis size; above 1 waits for the multi-GPU slice.")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="Model-parallel axis size; above 1 waits for the multi-GPU slice.")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="Multi-process training; waits for the multi-GPU slice.")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of process 0 (multi-GPU slice).")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--init-params", default=None,
                        help="Warm-start parameters from a .msgpack checkpoint (fresh optimizer; "
                             "unlike --resume-training).")
    parser.add_argument("--init-encoder", default=None,
                        help="Warm-start only the VGG encoder trunk from a .msgpack checkpoint or "
                             "encoder subtree.")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler Chrome trace of the run's second epoch.")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="Save epoch_N checkpoints every N epochs (best_network is always "
                             "saved when improved).")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="Maintain a per-step parameter EMA with this decay (e.g. 0.999); "
                             "checkpoints the best EMA snapshot as best_network_ema.*")
    parser.add_argument("--valid-every", type=int, default=1,
                        help="Run the validation pass every N epochs (the final epoch always "
                             "validates).")
    parser.add_argument("--grad-clip-norm", type=float, default=None,
                        help="Global-norm gradient clipping. Default: off.")
    parser.add_argument("--lr-decay-steps", type=int, default=None,
                        help="If set, cosine-decay the learning rate to ~0 over this many steps "
                             "(with --lr-warmup-steps linear warmup). Default: flat LR.")
    parser.add_argument("--lr-warmup-steps", type=int, default=0)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                        help="Model compute dtype (params, optimizer state and the loss stay "
                             "float32). Default: the architecture config's (float32 if unset).")
    parser.add_argument("--quant-mode", choices=["qat"], default=None,
                        help="Quantization-aware training (vgg only). Default: the architecture "
                             "config's value (off).")
    parser.add_argument("--loss-pos-weight", type=float, default=None,
                        help="Train with the weighted-MSE criterion (pixel weight 1 + (W-1)*target). "
                             "Default: the architecture config's loss.")
    parser.add_argument("--loss-sym", action="store_true", default=False,
                        help="With --loss-pos-weight: weight by max(target, stop_grad(pred)).")
    parser.add_argument("--cache-device", action="store_true", default=False,
                        help="Decode the dataset once and keep it in device memory; batches "
                             "become device-side gathers.")
    parser.add_argument("-s", "--random-seed", type=int)
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    parser.add_argument("-r", "--resume-training", action="store_true", default=False)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    train_network(make_parser().parse_args())
