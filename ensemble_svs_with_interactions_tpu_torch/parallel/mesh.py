"""Process groups and device meshes: the counterpart of
``ensemble_svs_with_interactions_tpu/parallel/mesh.py``.

The JAX package runs data parallelism as one global-view program (GSPMD
over a 1-D ``data`` mesh): every loss, batch statistic and NaN-skip is
computed over the GLOBAL batch and XLA inserts the collectives.  The port
runs one process per card over ``torch.distributed`` and inserts them by
hand, with the same semantics:

* every rank builds the same global batch from the same seed and takes its
  contiguous rows (:func:`shard_batch`);
* each loss term is this rank's numerator over the GLOBAL count
  (:func:`all_reduce_sum` of the local counts, ``train/losses.py``), so the
  ranks' losses sum to the global loss, and the gradients are SUMMED
  across ranks (one flat bucket a step, ``train/loop.reduce_grads``);
* batch norm takes count, sum and sum of squares over every rank
  (:func:`all_reduce_sum_autograd`, ``models/layers.MaskedBatchNorm``).

``DistributedDataParallel`` is not used: it averages each rank's
gradient of its own normalised loss, which is not the global-batch
gradient when the ranks hold different numbers of valid frames.

Without a process group every collective here is the identity and the
single-process path is unchanged.  Single-process serving shards a batch
over several local devices instead (``make_mesh``'s devices;
``gen.ModelPack.set_mesh``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: the devices this process shards over (repeats
    allowed: one card may hold several shards, run in turn) and, under a
    process group, this process's place in it.  The batch splits into
    ``world_size * len(devices)`` contiguous shards; this process holds
    shards ``rank * len(devices)`` onwards."""

    devices: tuple
    axis_names: tuple = ("data",)
    world_size: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        """Shards of the global batch."""
        return self.world_size * len(self.devices)


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if group_up() else 1


def rank() -> int:
    return dist.get_rank() if group_up() else 0


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    return int(os.environ[name]) if name in os.environ else None


def maybe_initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> int:
    """Join the process group at ``coordinator`` ("host:port") and return
    this process's rank; without a coordinator a no-op that returns 0, as
    the JAX package's.  ``num_processes`` / ``process_id`` default to
    torchrun's ``WORLD_SIZE`` / ``RANK``.  On a card the rank's device is
    ``LOCAL_RANK`` (else ``process_id % device_count``), made current.
    The backend is NCCL for cards, gloo for the CPU; ``backend="gloo"``
    lets ranks share one card, which NCCL refuses."""
    if not coordinator:
        return rank()
    world = _env_int("WORLD_SIZE", num_processes)
    pid = _env_int("RANK", process_id)
    if world is None or pid is None:
        raise ValueError("distributed: num_processes and process_id (or "
                         "WORLD_SIZE and RANK) are required")
    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        local = _env_int("LOCAL_RANK", None)
        torch.cuda.set_device(pid % torch.cuda.device_count()
                              if local is None else local)
    if not group_up():
        dist.init_process_group(
            backend or ("nccl" if kind == "cuda" else "gloo"),
            init_method=f"tcp://{coordinator}", world_size=world, rank=pid)
    return rank()


def _rank_device(kind: str) -> torch.device:
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def make_mesh(num_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",), device=None) -> Mesh:
    """A mesh over the first ``num_devices`` cards (all if None); on the
    CPU (``device="cpu"``), ``num_devices`` entries of the CPU device, the
    counterpart of JAX's virtual host devices.  ``device`` may instead be
    an explicit list of devices, repeats allowed.  Under a process group
    with ``num_devices`` None, each process's mesh holds its own device
    and the batch splits over the ranks.  Raises when fewer cards exist
    than asked."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device][:num_devices]
    else:
        kind = torch.device(device or "cuda").type
        if group_up() and num_devices is None:
            devices = [_rank_device(kind)]
        elif kind == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            n = count if num_devices is None else int(num_devices)
            if n < 1 or n > count:
                raise ValueError(f"make_mesh: {n} cards asked, {count} "
                                 "present")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device(kind)] * int(num_devices or 1)
    return Mesh(tuple(devices), tuple(axis_names), world_size(), rank())


def batch_sharding(mesh: Mesh, rows: int) -> list:
    """[(device, row slice)] of this process's shards of a ``rows``-row
    batch (a multiple of ``mesh.size``): contiguous, in mesh order."""
    if rows % mesh.size:
        raise ValueError(f"batch of {rows} rows over {mesh.size} shards")
    per = rows // mesh.size
    first = mesh.rank * len(mesh.devices)
    return [(d, slice((first + k) * per, (first + k + 1) * per))
            for k, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh) -> tuple:
    """The devices a replicated tensor lives on: each of the mesh's."""
    return mesh.devices


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """A dict of (B, ...) arrays or tensors -> one dict a local mesh
    device, each holding its contiguous rows as tensors on its device
    (under a process group: this rank's rows, in a one-item list)."""
    rows = len(next(iter(batch.values())))
    return [{k: torch.as_tensor(v[sl]).to(d, non_blocking=True)
             for k, v in batch.items()}
            for d, sl in batch_sharding(mesh, rows)]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def replicate_tree(tree, mesh: Mesh) -> list:
    """One copy of a tree of tensors a local mesh device.  Under a
    process group each rank's copy holds rank 0's values (broadcast in
    place: a module's ``state_dict()`` tensors are its own), the start
    every rank of a data-parallel run shares."""
    if mesh.world_size > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data, src=0)
    return [_tree_map(lambda t, d=d: t.to(d), tree) for d in mesh.devices]


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


# ------------------------------------------------ draws of a batch shard
_DRAW_ROWS = contextvars.ContextVar("draw_rows", default=None)


@contextlib.contextmanager
def drawing_rows(rows: slice, total: int):
    """Inside the block, a model run on the rows ``rows`` of a
    ``total``-row batch draws its random tensors (the AR decoders' dropout
    masks, the diffusion chains' noise, the postfilters' noise) at the
    whole batch's size and keeps its rows' (:func:`shard_draw`), so a
    batch sharded over a mesh draws what one device would draw for it, as
    the JAX package's global-view program does."""
    token = _DRAW_ROWS.set((rows, int(total)))
    try:
        yield
    finally:
        _DRAW_ROWS.reset(token)


def shard_draw(draw, shape, batch_axis: int):
    """``draw(shape)``; inside :func:`drawing_rows`, ``draw`` of the whole
    batch's shape (``total`` at ``batch_axis``) cut to the shard's rows."""
    spec = _DRAW_ROWS.get()
    if spec is None:
        return draw(tuple(shape))
    rows, total = spec
    if shape[batch_axis] != rows.stop - rows.start:
        raise ValueError(f"a draw of {shape} for rows {rows}")
    full = list(shape)
    full[batch_axis] = total
    return draw(tuple(full)).narrow(batch_axis, rows.start,
                                    rows.stop - rows.start)


# ----------------------------------------------------------- collectives
def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the process group, without gradient (a new
    tensor); ``t`` itself without a group."""
    if not group_up():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the process group, differentiable (the
    backward sums the ranks' gradients); ``t`` itself without a group."""
    if not group_up():
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped (B / n, ...) tensors stacked in rank order
    into the global (B, ...) batch, through one all-reduce (gloo gathers
    no card tensors)."""
    if not group_up():
        return t
    n, r = dist.get_world_size(), dist.get_rank()
    out = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
    out[r * t.shape[0]: (r + 1) * t.shape[0]] = t
    dist.all_reduce(out)
    return out


def barrier() -> None:
    if group_up():
        dist.barrier()
