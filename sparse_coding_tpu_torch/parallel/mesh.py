"""The ("model", "data") mesh on ``torch.distributed``: the counterpart of
the JAX package's ``parallel/mesh.py``.

Axes, as there:

- "model": the ensemble axis — members split across devices (one
  reference worker process per GPU), or a big SAE's features;
- "data": the batch axis — each device trains on its rows, and the
  gradients meet in an all-reduce over this axis.

One process per device. Where the JAX package runs one program over every
device (``shard_map``), each rank here holds its local shards as plain
tensors, runs the kernels on them, and calls an explicit collective —
:meth:`Mesh.psum`, :meth:`Mesh.all_gather` or :meth:`Mesh.ppermute` on the
axis's process group — at each point where the JAX code calls
``jax.lax.psum``, ``all_gather`` or ``ppermute``.
So ``compat_shard_map`` and ``compat_axis_size`` have no counterpart: the
local code is already written per shard, and an axis's size is
``mesh.shape[axis]``.

Rank r sits at (r // mesh_data, r % mesh_data), the row-major layout of
the JAX mesh's device grid (``make_mesh`` puts the model axis first so a
member's data shards are neighbours). ``torch.distributed.device_mesh``
builds the axis groups. The backend is ``nccl`` for a ``cuda`` mesh and
``gloo`` for a ``cpu`` one unless the caller names another; each rank
runs on ``cuda:LOCAL_RANK`` (or ``cpu`` when asked).

Start a mesh run with ``torchrun --nproc_per_node M*D`` (it sets
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``), or give
:func:`initialize_distributed` the rendezvous yourself.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

MODEL_AXIS = "model"
DATA_AXIS = "data"
AXES = (MODEL_AXIS, DATA_AXIS)

DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _axes(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are {AXES}")
    return axes


class Mesh:
    """This rank's view of a mesh_model × mesh_data mesh over the
    initialized world (or a world of one when none is initialized and the
    mesh is 1 × 1). ``shape`` is ``{"model": M, "data": D}`` as the JAX
    mesh's; ``coords`` this rank's (model, data) index; ``device`` the
    device its shards live on."""

    def __init__(self, mesh_model: int, mesh_data: int, device: torch.device,
                 device_mesh=None):
        self.shape = {MODEL_AXIS: int(mesh_model), DATA_AXIS: int(mesh_data)}
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        self.coords = {MODEL_AXIS: self.rank // self.shape[DATA_AXIS],
                       DATA_AXIS: self.rank % self.shape[DATA_AXIS]}

    @property
    def size(self) -> int:
        return self.shape[MODEL_AXIS] * self.shape[DATA_AXIS]

    @property
    def is_distributed(self) -> bool:
        return self.device_mesh is not None

    def __repr__(self) -> str:
        return (f"Mesh(model={self.shape[MODEL_AXIS]}, "
                f"data={self.shape[DATA_AXIS]}, rank={self.rank}, "
                f"device={self.device})")

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def _group_for(self, axes: tuple[str, ...]):
        if len(axes) == 2:
            return None  # the world
        return self.group(axes[0])

    def psum(self, tensors, axes=DATA_AXIS):
        """The sum over the ranks of ``axes`` (one name or both) of each
        tensor of ``tensors`` (one tensor, or a sequence): new tensors,
        the inputs untouched. Tensors of one dtype travel in one flat
        buffer, one all-reduce per dtype. Identity in a world of one."""
        single = isinstance(tensors, torch.Tensor)
        seq = [tensors] if single else list(tensors)
        axes = _axes(axes)
        if not self.is_distributed:
            out = [t.clone() for t in seq]
            return out[0] if single else out
        group = self._group_for(axes)
        out: list = [None] * len(seq)
        by_dtype: dict = {}
        for i, t in enumerate(seq):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([seq[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            offset = 0
            for i in idx:
                n = seq[i].numel()
                out[i] = flat[offset:offset + n].view(seq[i].shape)
                offset += n
        return out[0] if single else out

    def all_true(self, flag: torch.Tensor, axes=DATA_AXIS) -> torch.Tensor:
        """A bool tensor's AND over the ranks of ``axes``."""
        return self.psum((~flag).to(torch.int32), axes) == 0

    def all_gather(self, t: torch.Tensor, axis: str = MODEL_AXIS,
                   dim: int = 0) -> torch.Tensor:
        """The shards of ``t`` from every rank along ``axis``, concatenated
        on ``dim`` in the axis's order (the JAX ``all_gather(...,
        tiled=True)``). Identity in a world of one."""
        (axis,) = _axes(axis)
        if not self.is_distributed:
            return t.clone()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t.contiguous(), group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def ppermute(self, t: torch.Tensor, axis: str = DATA_AXIS,
                 shift: int = 1) -> torch.Tensor:
        """The ring shift along ``axis``: this rank sends ``t`` to the rank
        ``shift`` places on and returns what the rank ``shift`` places back
        sent (the JAX ``ppermute`` with the perm ``[(i, (i + shift) %
        P)]``), one paired ``batch_isend_irecv`` on the axis's group. A
        new tensor, the input untouched; identity in a world of one or on
        an axis of one. gloo's point-to-point ops read host memory only, so
        under gloo a CUDA tensor travels through pinned host buffers;
        NCCL sends it from the device."""
        (axis,) = _axes(axis)
        size = self.shape[axis]
        if not self.is_distributed or shift % size == 0:
            return t.clone()
        group = self.group(axis)
        me = self.coords[axis]
        dst = dist.get_global_rank(group, (me + shift) % size)
        src = dist.get_global_rank(group, (me - shift) % size)
        send = t.contiguous()
        staged = (t.device.type == "cuda"
                  and dist.get_backend(group) == "gloo")
        if staged:
            send = torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(send)  # blocking
            recv = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        else:
            recv = torch.empty_like(send)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]):
            work.wait()
        return recv.to(t.device) if staged else recv

    def barrier(self) -> None:
        if self.is_distributed:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dist.barrier()


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a ``cuda`` mesh (a
    missing card raises, as ``resolve_device`` does), else the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a cuda mesh needs a CUDA device and none is available; pass "
            "device_type='cpu' to run the mesh on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(mesh_model: int = 1, mesh_data: Optional[int] = None,
              device_type: Optional[str] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """Build the ("model", "data") mesh over the initialized world.

    ``mesh_data=None`` puts every remaining rank on the data axis. The
    world must hold exactly mesh_model × mesh_data ranks: a mesh smaller
    than the world would leave ranks outside every collective. A 1 × 1
    mesh needs no initialized world. ``device_type`` (default: the card
    when there is one, else the CPU) or an explicit ``device`` places this
    rank's shards."""
    n = _world_size()
    if mesh_model < 1 or (mesh_data is not None and mesh_data < 1):
        raise ValueError(f"mesh axes must be >= 1, got {mesh_model}x"
                         f"{mesh_data}")
    if mesh_data is None:
        if n % mesh_model != 0:
            raise ValueError(f"{n} ranks not divisible by mesh_model="
                             f"{mesh_model}")
        mesh_data = n // mesh_model
    use = mesh_model * mesh_data
    if use > n:
        raise ValueError(f"mesh {mesh_model}x{mesh_data} needs {use} ranks, "
                         f"have {n}")
    if use < n:
        raise ValueError(f"mesh {mesh_model}x{mesh_data} covers {use} of "
                         f"the world's {n} ranks; the world must equal the "
                         "mesh")
    if device is None:
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        device = default_device(device_type)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device and none is "
                           "available")
    if not dist.is_initialized():
        return Mesh(mesh_model, mesh_data, device)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    dm = init_device_mesh(device.type, (mesh_model, mesh_data),
                          mesh_dim_names=AXES)
    return Mesh(mesh_model, mesh_data, device, dm)


def single_device_mesh(device=None) -> Mesh:
    """A 1 × 1 mesh on ``device`` (default: as :func:`make_mesh`)."""
    return make_mesh(1, 1, device=device)


# -- placement helpers (thin aliases over the partition rule layer) ----------
#
# The one home of "which leaf lives where" is parallel/partition.py; these
# return its specs for the call sites that name a placement directly.


def batch_sharding(mesh: Mesh, stacked: bool = False):
    """Activations [batch, d], or a [K, batch, d] window stack when
    ``stacked``, split over the data axis (= partition.batch_spec)."""
    from sparse_coding_tpu_torch.parallel import partition

    return partition.batch_spec(stacked)


def ensemble_sharding(mesh: Mesh):
    """Stacked ensemble leaves [N, ...] split over the model axis."""
    from sparse_coding_tpu_torch.parallel import partition

    return partition.MEMBER


def replicated(mesh: Mesh):
    from sparse_coding_tpu_torch.parallel import partition

    return partition.REPLICATED


def feature_sharding(mesh: Mesh):
    """A big SAE's [n_feats, d] params split over "model" on the feature
    axis (= partition.FEATURE_ROWS)."""
    from sparse_coding_tpu_torch.parallel import partition

    return partition.FEATURE_ROWS


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device_type: Optional[str] = None,
                           store=None, timeout_s: float = 600.0) -> bool:
    """Join the world once per process before building a mesh. Reads
    torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``; a no-op (returns
    False) when they are absent and neither an address nor a ``store`` is
    given, or when the world is already up. ``coordinator_address`` is an
    ``init_method`` URL (``tcp://localhost:29500``, ``file:///path``).
    ``backend`` defaults to ``nccl`` for ``cuda`` and ``gloo`` for
    ``cpu`` (``device_type``, default: the card when there is one)."""
    import datetime

    if dist.is_initialized():
        return False
    if (coordinator_address is None and store is None
            and "MASTER_ADDR" not in os.environ):
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = backend or DEFAULT_BACKENDS[device_type]
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    kwargs = {"backend": backend, "rank": rank, "world_size": world,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = coordinator_address
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    return True


def shutdown_distributed() -> None:
    """Leave the world (every rank calls it once at the end)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_world_is_world() -> bool:
    """True when every rank of the world runs on this node
    (``LOCAL_WORLD_SIZE == WORLD_SIZE``, or no world at all): the
    port's counterpart of a single-host JAX mesh."""
    if not dist.is_initialized():
        return True
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               str(dist.get_world_size())))
    return local == dist.get_world_size()


__all__: Sequence[str] = [
    "MODEL_AXIS", "DATA_AXIS", "Mesh", "make_mesh", "single_device_mesh",
    "batch_sharding", "ensemble_sharding", "replicated", "feature_sharding",
    "initialize_distributed", "shutdown_distributed",
    "local_world_is_world", "default_device",
]
