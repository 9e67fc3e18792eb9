"""Data and channel (tensor) parallelism over PyTorch process groups.

Port of ``dream_tpu/parallel/mesh.py``.  JAX lays a ``(data, model)`` mesh
over the devices of one program and lets XLA insert the collectives; here
each mesh position is a process (a rank), and the collectives are written
out:

- one rank per ``(data, model)`` position, ``rank = data * n_model +
  model`` (the order of JAX's ``reshape(n_data, n_model)``); a *data group*
  for each model index (the ranks that hold the same parameter shards and
  see different rows) and a *model group* for each data index (the ranks
  that see the same rows and hold different shards);
- :func:`process_local_batch` / :func:`batch_sharding`: this rank's rows of
  a global batch (the ranks of one model group take the same rows);
- :func:`param_shardings`: JAX's rule on the port's parameter names and
  layouts (a conv weight with ``cout >= 256`` and ``cout % n_model == 0``
  is split over its output channels, dimension 0 of an OIHW weight and 1
  of a transposed conv's ``[in, out, kh, kw]``; a vector of that length
  too);
- :func:`shard_params`: each conv the rule selects keeps its
  ``cout / n_model`` output channels (its bias follows) and becomes a
  channel-split conv on the model group: its input passes through
  :class:`_CopyToModelGroup` (identity forward, gradient all-reduced over
  the group: each rank's partial input gradient is a sum over its own
  channels) and its output through :class:`_GatherChannels` (the pieces
  all-gathered along channels; the backward keeps this rank's slice of the
  incoming gradient: every model rank computes the same thing downstream,
  so summing over the ranks, as ``torch.distributed.nn``'s all-gather
  does, would multiply the split convs' gradients by ``n_model``).
  BatchNorm vectors the rule selects stay whole: the gathered activations
  they normalise are whole on every rank.  Flax shards them as a layout
  only, which changes no arithmetic;
- :func:`global_loss` and :func:`reduce_gradients`: the loss over the
  global batch (numerator and denominator all-reduced over the data group,
  since the weighted-MSE normaliser is a sum over the whole batch) and the
  gradients averaged over the data group, so a D-rank step equals the
  1-rank step on the same global batch up to the order of the sums;
  BatchNorm's batch statistics are all-reduced in
  ``models.layers._BatchStatsNorm``.

The backend is explicit: ``nccl`` when each rank owns a GPU, ``gloo`` on
the CPU or for ranks that share one card.  NCCL with two ranks on one
device raises.  Under gloo the collectives on tensors are ``all_reduce``
and ``broadcast`` alone (the channel gather sums zero-padded pieces),
which gloo carries on CPU and CUDA tensors, narrower floats as float32;
under NCCL the gather is ``all_gather_into_tensor``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import socket
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

_MIN_SHARD_CHANNELS = 256
BACKENDS = ("nccl", "gloo")


def default_backend(device: Any) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device: Any) -> None:
    """NCCL carries CUDA tensors alone; raise on any other pairing."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device: Any = "cuda") -> Dict[str, Any]:
    """Join a process group: ``torch.distributed.init_process_group`` on
    ``tcp://<coordinator_address>`` (``host:port`` of process 0) with
    ``num_processes`` ranks, this one ``process_id``.  Without a coordinator
    address the ``env://`` method reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``backend`` defaults to
    :func:`default_backend` of ``device``.  Under NCCL this rank takes GPU
    ``LOCAL_RANK`` (``process_id`` modulo the GPU count when unset).

    Returns ``{"process_index", "process_count", "local_device_count",
    "device"}``, JAX's keys plus this rank's device.
    """
    backend = backend or default_backend(device)
    check_backend(backend, device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    rank = dist.get_rank()
    device = torch.device(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return {"process_index": rank, "process_count": dist.get_world_size(),
            "local_device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
            "device": device}


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(data, model)`` mesh of ranks.

    ``shape`` is ``{"data": n_data, "model": n_model}`` as JAX's
    ``Mesh.shape``; ``data_group`` and ``model_group`` are this rank's
    process groups (None without a process group: the one-rank mesh).
    """

    shape: Dict[str, int]
    rank: int
    data_index: int
    model_index: int
    device: torch.device
    backend: Optional[str]
    data_group: Any = None
    model_group: Any = None

    @property
    def world_size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        n_data = self.shape["data"]
        if n % n_data:
            raise ValueError(f"a global batch of {n} does not divide over {n_data} data ranks")
        per = n // n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def _check_devices(backend: str, device: torch.device) -> None:
    """Under NCCL, raise when two ranks sit on one device (NCCL refuses
    them, and may hang before it says so).  The ranks exchange their host
    and device over a gloo group."""
    if backend != "nccl":
        return
    group = dist.new_group(backend="gloo")
    places: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(places, (socket.gethostname(), str(device)), group=group)
    dist.destroy_process_group(group)
    seen: Dict[Any, int] = {}
    for rank, place in enumerate(places):
        if place in seen:
            raise RuntimeError(f"NCCL: ranks {seen[place]} and {rank} are both on {place[1]} of "
                               f"{place[0]}; give each rank its own GPU, or use the gloo backend "
                               "for ranks that share one card")
        seen[place] = rank


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """This rank's ``(data, model)`` mesh over the ranks of the process
    group (collective: every rank calls it, with the same sizes).

    ``n_data`` defaults to the world size over ``n_model``, and
    ``n_data * n_model`` must be the world size.  ``devices`` lists each
    rank's device (repeated where ranks share one card under gloo); by
    default a rank is on the current CUDA device under NCCL and on the CPU
    under gloo.  Without a process group the mesh is the one-rank mesh,
    with no groups, on ``devices[0]`` (default ``cuda``).
    """
    if not dist.is_initialized():
        if (n_data or 1) * n_model != 1:
            raise RuntimeError(f"a {n_data}x{n_model} mesh needs {(n_data or 1) * n_model} ranks; "
                               "join a process group first (initialize_distributed)")
        device = torch.device(devices[0] if devices else "cuda")
        return Mesh({"data": 1, "model": 1}, 0, 0, 0, device, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"{world} ranks do not divide over a model axis of {n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, have {world}")
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    elif backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    check_backend(backend, device)
    _check_devices(backend, device)
    data_index, model_index = divmod(rank, n_model)
    data_group = model_group = None
    # Every rank creates every group, in the same order.
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_index:
            data_group = group
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_index:
            model_group = group
    return Mesh({"data": n_data, "model": n_model}, rank, data_index, model_index, device,
                backend, data_group, model_group)


def process_local_batch(mesh: Mesh, array):
    """This rank's rows of a global batch (leading axis)."""
    return array[mesh.rows(array.shape[0])]


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Callable:
    """The map from a global batch to this rank's rows (JAX's
    ``P("data", None, ...)``); ``ndim`` is accepted for the JAX signature."""
    del ndim
    return functools.partial(process_local_batch, mesh)


def _whole(array):
    return array


def replicated_sharding(mesh: Mesh) -> Callable:
    """Every rank holds the whole array: the identity."""
    del mesh
    return _whole


def _out_dim(module: nn.Module) -> int:
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """JAX's rule for each parameter of ``model``: the dimension split over
    the model axis, or None where the parameter is whole.  A conv weight
    splits its output channels when there are at least 256 of them and
    they divide by ``n_model``; a vector of such a length splits too."""
    n_model = mesh.shape["model"]
    rule: Dict[str, Optional[int]] = {}
    for module_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{module_name}.{leaf}" if module_name else leaf
            dim = None
            if n_model > 1:
                if p.dim() == 4:
                    cand = _out_dim(module)
                elif p.dim() == 1:
                    cand = 0
                else:
                    cand = None
                if (cand is not None and p.shape[cand] >= _MIN_SHARD_CHANNELS
                        and p.shape[cand] % n_model == 0):
                    dim = cand
            rule[name] = dim
    return rule


def _collective_dtype(mesh_backend: Optional[str], x: torch.Tensor) -> torch.dtype:
    """NCCL takes the tensor's own dtype; gloo reduces float32 and float64,
    so narrower floats travel as float32."""
    if mesh_backend == "nccl" or x.dtype == torch.float64:
        return x.dtype
    return torch.float32


class _CopyToModelGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces (sums) the gradient over
    the model group: each split conv's input gradient is a sum over its
    ``cout`` channels, and each rank holds a part of them."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        g = grad.to(_collective_dtype(mesh.backend, grad)).contiguous()
        dist.all_reduce(g, group=mesh.model_group)
        return g.to(grad.dtype), None


class _GatherChannels(torch.autograd.Function):
    """All-gather NCHW pieces along channels (rank order); the backward keeps
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        n_model, c = mesh.shape["model"], y.shape[1]
        ctx.c = c
        dtype = _collective_dtype(mesh.backend, y)
        if mesh.backend == "nccl":
            pieces = torch.empty((n_model,) + tuple(y.shape), dtype=dtype, device=y.device)
            dist.all_gather_into_tensor(pieces, y.contiguous(), group=mesh.model_group)
            full = pieces.movedim(0, 1).reshape(y.shape[0], n_model * c, *y.shape[2:])
        else:
            # gloo: each rank writes its slot of a zero tensor and the sum
            # assembles the whole (adding zeros is exact).
            full = torch.zeros((y.shape[0], n_model * c) + tuple(y.shape[2:]), dtype=dtype,
                               device=y.device)
            full[:, mesh.model_index * c:(mesh.model_index + 1) * c] = y
            dist.all_reduce(full, group=mesh.model_group)
        return full.to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        i, c = ctx.mesh.model_index, ctx.c
        return grad[:, i * c:(i + 1) * c].contiguous(), None


def _split_pre_hook(mesh: Mesh, module: nn.Module, args):
    return (_CopyToModelGroup.apply(args[0], mesh),) + tuple(args[1:])


def _split_hook(mesh: Mesh, module: nn.Module, args, output):
    return _GatherChannels.apply(output, mesh)


def _narrow(tensor: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    size = tensor.shape[dim] // mesh.shape["model"]
    return tensor.narrow(dim, mesh.model_index * size, size).clone()


def shard_params(model: nn.Module, mesh: Mesh, optimizer: Optional[torch.optim.Optimizer] = None,
                 extra_states: Iterable[Dict[str, torch.Tensor]] = ()) -> Dict[str, int]:
    """Make every conv :func:`param_shardings` splits a channel-split conv on
    the model group, in place: its weight and bias keep this rank's output
    channels (the same ``nn.Parameter`` objects, so an optimizer built
    before keeps them; its per-parameter state is cut the same way, as are
    the tensors of ``extra_states`` under the parameters' names, e.g. an
    EMA), and hooks gather its output.  Returns the split parameters'
    names and dimensions."""
    rule = param_shardings(model, mesh)
    split: Dict[str, int] = {}
    if mesh.shape["model"] == 1:
        return split
    for module_name, module in model.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        weight_name = f"{module_name}.weight" if module_name else "weight"
        dim = rule.get(weight_name)
        if dim is None:
            continue
        leaves = [("weight", dim)] + ([("bias", 0)] if module.bias is not None else [])
        for leaf, d in leaves:
            p = getattr(module, leaf)
            name = f"{module_name}.{leaf}" if module_name else leaf
            with torch.no_grad():
                p.data = _narrow(p.data, d, mesh)
            if optimizer is not None:
                for key, value in optimizer.state.get(p, {}).items():
                    if torch.is_tensor(value) and value.dim() == p.dim():
                        optimizer.state[p][key] = _narrow(value, d, mesh)
            for state in extra_states:
                if name in state:
                    state[name] = _narrow(state[name], d, mesh)
            split[name] = d
        module.register_forward_pre_hook(functools.partial(_split_pre_hook, mesh))
        module.register_forward_hook(functools.partial(_split_hook, mesh))
    return split


def gather_full(tensor: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each model rank's piece along ``dim``
    (collective over the model group)."""
    dtype = _collective_dtype(mesh.backend, tensor)
    size = tensor.shape[dim]
    shape = list(tensor.shape)
    shape[dim] = size * mesh.shape["model"]
    full = torch.zeros(shape, dtype=dtype, device=tensor.device)
    full.narrow(dim, mesh.model_index * size, size).copy_(tensor)
    dist.all_reduce(full, group=mesh.model_group)
    return full.to(tensor.dtype)


def gather_state(state: Dict[str, torch.Tensor], split: Dict[str, int],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``state`` with each split entry gathered whole, in the layout a
    one-rank run holds (collective over the model group)."""
    return {name: gather_full(t, split[name], mesh) if name in split else t
            for name, t in state.items()}


def global_loss(num: torch.Tensor, den: torch.Tensor, mesh: Mesh):
    """``(objective, value)`` of a loss ``sum(num) / sum(den)`` over the
    global batch, from this rank's terms: ``value`` is that ratio (the same
    on every rank), and ``objective`` the term whose gradient, averaged over
    the data group (:func:`reduce_gradients`), is the ratio's gradient.
    The denominator takes no gradient."""
    dtype = torch.promote_types(num.dtype, torch.float32)
    totals = torch.stack([num.detach().to(dtype), den.detach().to(dtype)])
    dist.all_reduce(totals, group=mesh.data_group)
    return num * (mesh.shape["data"] / totals[1]), totals[0] / totals[1]


def reduce_gradients(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average the parameters' gradients over the data group, in place: one
    all-reduce of the gradients laid end to end."""
    grads = [p.grad for p in params]
    dtype = torch.promote_types(grads[0].dtype, torch.float32)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.shape["data"]
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def sum_over_model_group(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``value`` summed over the model group (a new tensor, float32 or
    wider: a float64 model's clipping norm stays float64)."""
    total = value.detach().to(torch.promote_types(value.dtype, torch.float32)).clone()
    dist.all_reduce(total, group=mesh.model_group)
    return total


def broadcast_value(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``value`` on every rank (a new tensor), so that decisions
    taken on it agree."""
    out = value.detach().to(torch.float32).clone()
    if mesh.data_group is not None or mesh.model_group is not None:
        dist.broadcast(out, src=0)
    return out


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world: int, port: int, backend: str,
                devices: Sequence[str], result_dir: str, tf32: Sequence[bool], fn_args: tuple) -> None:
    device = torch.device(devices[rank])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if device.type == "cpu":
        # Ranks that share a host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    else:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        result = fn(rank, *fn_args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(result_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def rank_devices(world: int, device: Any, backend: str) -> List[str]:
    """Each local rank's device: under NCCL GPU ``r`` for rank ``r`` (raises
    when the host has fewer GPUs than ranks); under gloo every rank on
    ``device``."""
    check_backend(backend, device)
    if backend == "nccl":
        count = torch.cuda.device_count()
        if world > count:
            raise RuntimeError(f"NCCL needs a GPU for each of {world} ranks; this host has "
                               f"{count}. Ranks that share one card need the gloo backend")
        return [f"cuda:{r}" for r in range(world)]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return [str(device)] * world


def spawn_local_ranks(fn: Callable, world: int, backend: str, devices: Sequence[str],
                      *fn_args) -> List[Any]:
    """Run ``fn(rank, *fn_args)`` in ``world`` fresh processes (spawned, so
    each imports the package anew), joined in a process group on a free
    loopback port, rank ``r`` on ``devices[r]``, with this process's TF32
    settings (a fresh process has cuDNN's TF32 on); return their results in
    rank order.  ``fn`` must be importable (a module-level function); a
    rank that raises makes this raise."""
    import torch.multiprocessing as mp

    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory() as result_dir:
        mp.spawn(_rank_entry, args=(fn, world, free_port(), backend, list(devices), result_dir, tf32,
                                    fn_args), nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(result_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
