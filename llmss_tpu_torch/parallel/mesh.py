"""Mesh construction, process-group start-up and dtype policy
(counterpart: llmss_tpu/parallel/mesh.py).

The reference runs one controller process per host and expresses
parallelism as named axes of a ``jax.sharding.Mesh``; XLA compiles the
collectives. The port runs SPMD in the way the reference's own upstream
did (``torchrun``, one process per rank): every rank executes the same
program on its slice of the parameters, the cache and the batch, and the
collectives are explicit ``torch.distributed`` calls
(``parallel/sharding.py``).

Axes, outermost first (the reference's ``AXIS_ORDER``):

- ``dp``: data parallelism (replicated weights, the batch's rows split);
- ``sp``: sequence parallelism (the KV cache's ring split into chunks,
  ring prefill and the LSE-merge decode, ``ops/ring_attention.py``);
- ``tp``: Megatron tensor parallelism (heads, MLP columns and the vocab
  split).

A ``Mesh`` is one rank's view: the plan's sizes, the rank's coordinate
on each axis, and (when built by ``make_mesh`` over a process group) one
process group per axis from ``torch.distributed.device_mesh``.
``Mesh.local`` builds the view alone, with no group: what a loader or
``shard_params`` needs to cut a rank's slices.

The backend is explicit: ``nccl`` on CUDA and ``gloo`` on the CPU unless
the caller names another. Gloo over CUDA tensors (several ranks sharing
one card, which NCCL refuses) stages every collective through the host,
counted (``sharding.HOST_STAGING``), and cannot be captured in a CUDA
graph, so an engine on such a mesh runs its steps eagerly.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from llmss_tpu_torch.device import resolve_device

AXIS_DP = "dp"
AXIS_SP = "sp"
AXIS_TP = "tp"
AXIS_ORDER = (AXIS_DP, AXIS_SP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A parallelism plan: how many ranks along each named axis;
    ``tp=None`` means all remaining ranks (the reference's default: the
    whole world is the TP group)."""

    dp: int = 1
    sp: int = 1
    tp: int | None = None

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        tp = self.tp
        if tp is None:
            if n_devices % (self.dp * self.sp) != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by dp*sp="
                    f"{self.dp * self.sp}"
                )
            tp = n_devices // (self.dp * self.sp)
        total = self.dp * self.sp * tp
        if total != n_devices:
            raise ValueError(
                f"plan dp={self.dp} sp={self.sp} tp={tp} needs {total} "
                f"devices, have {n_devices}"
            )
        return self.dp, self.sp, tp


def default_backend(device: torch.device) -> str:
    """``nccl`` on CUDA, ``gloo`` on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def default_compute_dtype(device=None) -> torch.dtype:
    """bf16 on CUDA, fp32 on the CPU (the reference: bf16 on the TPU)."""
    return (torch.bfloat16 if resolve_device(device).type == "cuda"
            else torch.float32)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` (default ``cuda``), a GPU without an
    index taking its local rank's (``LOCAL_RANK`` under torchrun, modulo
    the cards present, so ranks that share one card all take it)."""
    dev = resolve_device(device)  # raises for CUDA without a GPU
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device=None,
) -> str:
    """Join the default process group (the reference's
    ``initialize_runtime``, the torch port's ``init_process_group``) and
    return its backend. A no-op once joined.

    - Explicit ``coordinator_address`` (``host:port`` for TCP, or a URL
      such as ``file:///path``), ``num_processes`` and ``process_id``:
      those, as in the reference's signature;
    - else torchrun's environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``): ``env://``;
    - else a world of one (an in-memory store): a mesh of one rank.

    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU
    (``device``, by default the GPU); gloo over CUDA tensors only when the
    caller names it."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = rank_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id go together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_backend()


class Mesh:
    """One rank's view of a ``dp x sp x tp`` mesh: sizes (``shape``, a
    dict by axis name, as the reference's ``mesh.shape``), this rank's
    coordinate on each axis, its device, and, over a process group, the
    group of each axis and the backend."""

    def __init__(self, sizes: tuple[int, int, int],
                 coords: tuple[int, int, int], device, *,
                 backend: str | None = None, device_mesh=None):
        self.shape = dict(zip(AXIS_ORDER, (int(s) for s in sizes)))
        self.coords = dict(zip(AXIS_ORDER, (int(c) for c in coords)))
        for ax in AXIS_ORDER:
            if not 0 <= self.coords[ax] < self.shape[ax]:
                raise ValueError(f"coordinate {self.coords[ax]} outside "
                                 f"{ax}={self.shape[ax]}")
        self.device = torch.device(device)
        self.backend = backend
        self.device_mesh = device_mesh

    @classmethod
    def local(cls, plan: MeshPlan | tuple[int, int, int],
              coords: tuple[int, int, int] = (0, 0, 0), device="cpu"
              ) -> "Mesh":
        """A view with no process group: the plan's sizes (``tp`` must be
        set) and a rank's coordinates, for cutting that rank's slices."""
        sizes = ((plan.dp, plan.sp, plan.tp) if isinstance(plan, MeshPlan)
                 else tuple(plan))
        if None in sizes:
            raise ValueError("Mesh.local needs every axis size")
        return cls(sizes, coords, device)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def world(self) -> int:
        return self.shape[AXIS_DP] * self.shape[AXIS_SP] * self.shape[AXIS_TP]

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError("this mesh has no process group "
                               "(Mesh.local): it cannot run collectives")
        return self.device_mesh.get_group(axis)

    @property
    def host_staged(self) -> bool:
        """Gloo over CUDA tensors: every collective goes through the host."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether steps over this mesh can be CUDA-graph captured: on the
        card under NCCL (gloo's collectives run on the host)."""
        return self.device.type == "cuda" and self.backend == "nccl"

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={self.shape[a]}" for a in AXIS_ORDER)
        at = ", ".join(f"{a}={self.coords[a]}" for a in AXIS_ORDER)
        return f"Mesh({sizes}; at {at}; {self.backend}, {self.device})"


def make_mesh(plan: MeshPlan | None = None, *, device=None,
              backend: str | None = None) -> Mesh:
    """This rank's mesh for ``plan`` over the default process group
    (joined first by ``initialize_runtime`` when it is not), with one
    group per axis from ``init_device_mesh(..., mesh_dim_names=("dp",
    "sp", "tp"))``. ``device``: this rank's (default: the GPU of its local
    rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(device)
    backend = initialize_runtime(backend=backend, device=dev)
    plan = plan or MeshPlan()
    sizes = plan.resolve(dist.get_world_size())
    # Only the groups are used: a CPU device mesh keeps init_device_mesh
    # from binding a card to each rank under gloo.
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", sizes,
                          mesh_dim_names=AXIS_ORDER)
    return Mesh(sizes, tuple(dm.get_coordinate()), dev, backend=backend,
                device_mesh=dm)
