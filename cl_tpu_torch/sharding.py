"""Data and spatial parallelism across cards: the process group, the
rank's rows of the global batch (or of every image), the collectives of a
sharded step, and the 2-D mesh's channel-sharding rule.

The counterpart of ``cl_tpu/sharding.py`` and of the mesh routes of
``cl_tpu/train.py``. ``cl_tpu`` runs one controller over a 1-D mesh of
every device, the batch sharded on its leading axis and the state
replicated; the port runs one process per card in a ``torch.distributed``
group, each holding the whole replicated state:

  * every process builds the same seeded global batch and trains on its
    contiguous rows ``[r·B/n, (r+1)·B/n)`` (``DataParallel.rows``; the
    layout of ``cl_tpu``'s ``process_local_rows``), the replay rows
    included, so the global batch and its replay width must divide by the
    group's size (``check_divisible``);
  * BatchNorm's statistics are sums over the global batch, through an
    all-reduce that autograd sees (``all_reduce_sum``): its backward
    all-reduces the cotangent, as ``SyncBatchNorm`` does, so every rank's
    statistics' gradients hold the other ranks' part;
  * each rank's loss is its share of the global mean, its own kernel
    total over the global pixel count (``pixel_count``): the shares sum to
    the mean, and the gradient is the SUM of the ranks' gradients, one
    flat all-reduce of the gradient buffer (``all_reduce_grads``);
  * collectives are all-reduce and barrier only: gloo does both on CUDA
    tensors, so two ranks can share one card over gloo (NCCL refuses two
    ranks on one card).

Under ``train.spatial_parallel`` (``SpatialParallel``, which takes
precedence over data parallelism) every rank holds the whole replicated
batch, the replay rows and the augment included, and computes rows
``[r·H/n, (r+1)·H/n)`` of every level (``parallel/spatial.py``); the loss,
the gradient's all-reduce and the replicated EWC penalty are those of data
parallelism, over the rank's rows of every image. ``make_mesh_2d`` /
``param_specs`` are ``cl_tpu``'s ``('data', 'model')`` mesh and its rule
for sharding conv output channels over the model axis ("TP readiness"):
no training path uses them, in ``cl_tpu`` either; ``gathered_forward``
runs the model from weights stored as shards.

Launching (``join``): a process joins the default group the caller
initialized (the CPU tests, a gloo group), or the one that ``torchrun``
names in the environment (NCCL on cards, gloo on the CPU), pinned to
``cuda:LOCAL_RANK``. With ``train.data_parallel`` and more than one
visible card and no group, ``train()`` spawns one worker per card
(``spawn``) and returns rank 0's report, as ``cl_tpu``'s single
controller does; with one card, or with ``data_parallel=false``, nothing
changes (``cl_tpu``'s ``len(jax.devices()) > 1`` rule). A failed group
init raises, and ``train.multihost=true`` with no group named raises
(``cl_tpu``'s ``initialize_multihost``): never N independent replicas.
"""

from __future__ import annotations

import os
import pickle
import queue as _queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def check_divisible(global_batch: int, world: int) -> None:
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} devices")


class DataParallel:
    """This process's place in the default process group: its ``rank``,
    the group's size ``world``, and the device the collectives' small
    tensors live on. Shared, never copied: a deep copy of a model (the LwF
    teacher) keeps the same object."""

    spatial = False  # each rank trains on its rows of the batch

    def __init__(self, device: torch.device | str = "cpu", *, alone: bool = False):
        """``alone``: a group of this process only (rank 0 of 1, no
        collective), the one-rank reference of a sharded run."""
        self.rank, self.world = (0, 1) if alone else (dist.get_rank(), dist.get_world_size())
        self.device = torch.device(device)

    def __deepcopy__(self, memo):
        return self

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n_global``."""
        check_divisible(n_global, self.world)
        per = n_global // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local(self, batch):
        """This rank's rows of a batch (a ``HostBatch`` or any tuple of
        arrays or tensors with the batch first)."""
        sl = self.rows(len(batch[0]))
        return type(batch)(*(a[sl] for a in batch))

    def global_shape(self, shape) -> tuple:
        """The shape of the global tensor of which a tensor of ``shape``
        is this rank's part."""
        return (shape[0] * self.world,) + tuple(shape[1:])

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global tensor."""
        return t[self.rows(t.shape[0])]

    def output_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a tensor computed from the batch the rank
        was given (the labels after the augment): here the tensor itself,
        since the rank was given its rows."""
        return t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the group, outside autograd."""
        if self.world > 1:
            dist.all_reduce(t)
        return t

    def barrier(self) -> None:
        """Every rank reaches this point before any goes on (an all-reduce
        of one element: the same call on gloo and NCCL)."""
        self.all_reduce_(torch.zeros(1, device=self.device))


class SpatialParallel(DataParallel):
    """This process's place in a height-sharded group
    (``train.spatial_parallel``, ``parallel/spatial.py``): every rank holds
    the whole replicated batch, the replay rows and the augment included,
    and computes rows ``[r·H/n, (r+1)·H/n)`` of every level
    (``cl_tpu/train.py:1062-1064``: the batch replicated, H sharded)."""

    spatial = True

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of a height of ``n_global``."""
        if n_global % self.world:
            raise ValueError(f"height {n_global} does not divide over {self.world} ranks")
        per = n_global // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def local(self, batch):
        """The batch itself: every rank holds all of it."""
        return batch

    def global_shape(self, shape) -> tuple:
        return (shape[0], shape[1] * self.world) + tuple(shape[2:])

    def own(self, t: torch.Tensor) -> torch.Tensor:
        return t[:, self.rows(t.shape[1])]

    def output_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a [B, H, ...] tensor of the whole batch."""
        return self.own(t)


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; its backward all-reduces the cotangent, since every
    rank's y depends on every rank's x."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.all_reduce_(g.detach().clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Σ over the group's ranks, differentiable (``lax.psum`` inside
    ``shard_map``); x itself without a group."""
    return x if dp is None else _AllReduceSum.apply(x, dp)


def pixel_count(labels: torch.Tensor, ignore_index: int, dp: DataParallel | None = None):
    """max(1, the count of non-ignored pixels) as f32: of this batch, or
    with ``dp`` of the global batch (``max(psum(n), 1)`` of ``cl_tpu``'s
    sharded losses)."""
    n = (labels != ignore_index).sum().float()
    if dp is not None:
        n = dp.all_reduce_(n.reshape(1)).reshape(())
    return n.clamp_min(1.0)


@torch.no_grad()
def all_reduce_grads(params, dp: DataParallel) -> None:
    """Sum every param's ``.grad`` over the group in one flat all-reduce
    (the gradient of the global loss is the sum of the ranks' shares')."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dp.all_reduce_(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


# ---------------------------------------------------------------------------
# The 2-D mesh: conv output channels over a model axis (cl_tpu/sharding.py:
# 104-143, "TP readiness"). No training path uses it, in cl_tpu either.
# ---------------------------------------------------------------------------

DATA_AXIS, MODEL_AXIS = "data", "model"


def make_mesh_2d(model: int, world: int | None = None, device_type: str = "cuda"):
    """A ``("data", "model")`` device mesh of shape (world / model, model)
    over the default group (``world`` None: its size); raises
    ``ValueError`` when ``model`` does not divide the world."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world is None else world
    if world % model:
        raise ValueError(f"{world} devices not divisible by model={model}")
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_specs(model, mesh, *, min_channels: int = 64) -> dict:
    """Each parameter's placements on ``mesh`` by name: a 4-D weight whose
    output channels (``interop.output_channel_dim``: dim 0 of a conv or
    the head, dim 1 of a transposed conv, flax's HWIO last axis either
    way) number at least ``min_channels`` and divide by the model axis is
    sharded on that dim over the model axis and replicated over the data
    axis; everything else is replicated. A mesh without a model axis
    replicates everything."""
    from torch.distributed.tensor import Replicate, Shard

    from cl_tpu_torch.interop import output_channel_dim

    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    if MODEL_AXIS not in mesh.mesh_dim_names:
        return {name: rep for name, _ in model.named_parameters()}
    ax = mesh.mesh_dim_names.index(MODEL_AXIS)
    m = mesh.size(ax)
    specs = {}
    for name, p in model.named_parameters():
        d = output_channel_dim(name)
        if p.ndim == 4 and p.shape[d] >= min_channels and p.shape[d] % m == 0:
            specs[name] = rep[:ax] + (Shard(d),) + rep[ax + 1:]
        else:
            specs[name] = rep
    return specs


def shard_params(model, mesh, specs: dict) -> dict:
    """The model's parameters stored as ``DTensor``s on ``mesh`` by
    ``specs``: each rank keeps only its shard of a sharded weight."""
    from torch.distributed.tensor import distribute_tensor

    return {name: distribute_tensor(p.detach(), mesh, specs[name])
            for name, p in model.named_parameters()}


def gathered_forward(model, x: torch.Tensor, shards: dict) -> torch.Tensor:
    """The model's forward on ``x`` from parameters stored as shards
    (``shard_params``): each weight gathered at use over the model axis
    (``full_tensor``), so the logits are the replicated model's. (DTensor's
    own convolution rule propagates only the input's placement and would
    ignore a sharded weight.)"""
    full = {name: t.full_tensor() for name, t in shards.items()}
    return torch.func.functional_call(model, full, (x,))


# ---------------------------------------------------------------------------
# Launching
# ---------------------------------------------------------------------------

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(device: torch.device) -> torch.device:
    """``cuda`` with no index under a group is this process's card."""
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def join(cfg, device: torch.device) -> DataParallel | None:
    """This process's ``DataParallel`` for ``cfg`` on ``device`` (a
    ``SpatialParallel`` under ``train.spatial_parallel``), or None (one
    process). A group the caller initialized is used as it is; else,
    under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment), the
    process joins the group the environment names, NCCL on a card and
    gloo on the CPU, and a failed init raises. ``train.multihost=true``
    with no group named raises; a group of more than one process with
    neither ``train.spatial_parallel`` nor ``train.data_parallel`` raises
    too (N processes would train N replicas)."""
    t = cfg.train
    if not dist.is_initialized() and _env_world() > 1:
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE={_env_world()} but {missing} unset: launch the "
                               "processes with torchrun")
        if device.type == "cuda":
            torch.cuda.set_device(local_rank())
        try:
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method="env://")
        except (RuntimeError, ValueError) as e:
            raise RuntimeError("the process group named in the environment failed to "
                               "initialize; refusing to train independent replicas") from e
    if not dist.is_initialized():
        if t.multihost:
            raise RuntimeError(
                "train.multihost=true but no process group is named: launch one process per "
                "card with torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or drop "
                "the flag for one host")
        return None
    world = dist.get_world_size()
    if world == 1:
        return None
    if t.spatial_parallel:  # takes precedence over data parallelism (cl_tpu/train.py:1062)
        return SpatialParallel(device=rank_device(device))
    if not t.data_parallel:
        raise ValueError(f"{world} processes in the group but train.data_parallel=false: "
                         "each would train a replica of its own")
    return DataParallel(device=rank_device(device))


def leave() -> None:
    """Destroy the default group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def should_spawn(cfg, device: torch.device) -> bool:
    """``train.data_parallel`` or ``train.spatial_parallel``, no group and
    none named in the environment, the card unpinned (``cuda`` with no
    index) and more than one visible: ``train()`` spawns one worker per
    card."""
    return ((cfg.train.data_parallel or cfg.train.spatial_parallel) and device.type == "cuda" and device.index is None
            and not dist.is_initialized() and _env_world() == 1
            and torch.cuda.device_count() > 1)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, backend, init_method, device, fn, args, queue):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        try:
            out = fn(*args)
        finally:
            leave()
        # plain pickle bytes: a tensor through the queue would travel by
        # shared memory that this process takes with it when it exits
        queue.put((rank, True, pickle.dumps(out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn, args=(), *, world: int, backend: str, init_method: str,
          devices, timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method), rank r on ``devices[r]`` in a group of ``backend`` at
    ``init_method``; returns each rank's result, by rank. A rank that
    fails ends the others and raises here with its traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, backend, init_method, str(devices[r]),
                                               fn, args, queue), daemon=False)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world and not errors:
            try:
                rank, ok, out = queue.get(timeout=0.5)
            except _queue.Empty:
                ended = all(p.exitcode is not None for p in procs)
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline or (ended and queue.empty()):
                    break
                continue
            if ok:
                results[rank] = pickle.loads(out)
            else:
                errors[rank] = out
    finally:
        if errors or len(results) < world:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) < world:
        lost = sorted(set(range(world)) - set(results) - set(errors))
        raise RuntimeError("data-parallel worker failed: "
                           + "; ".join(f"rank {r}: {tb}" for r, tb in sorted(errors.items()))
                           + (f"; ranks {lost} ended without a result" if lost else ""))
    return [results[r] for r in range(world)]


def spawn_cards(fn, args=()) -> list:
    """``spawn`` over every visible card, NCCL at a free local port."""
    n = torch.cuda.device_count()
    return spawn(fn, args, world=n, backend="nccl",
                 init_method=f"tcp://localhost:{free_port()}",
                 devices=[f"cuda:{r}" for r in range(n)])
