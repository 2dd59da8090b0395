"""The rank's mesh: one process per rank over a torch.distributed process
group (counterpart of gnn_tumor_seg_tpu/parallel/mesh.py).

The JAX package builds a 2-axis device mesh ("data", "model") inside one
program and lets XLA insert the collectives. Here each rank is a process
that owns one device; `Mesh` holds the world size, the rank, the rank's
device, the backend and the process group, with the data and model axis
sizes. Only n_model = 1 is ported: tensor parallelism (JAX
parallel/dp.py:27-47, `tp_leaf_spec`) is queued in ROADMAP.md.

`initialize_multihost` (JAX `:34`, jax.distributed.initialize) becomes
`init_process_group` with a TCP init method and a timeout. Rank r uses
cuda:(r % torch.cuda.device_count()). The backend is chosen once, from the
device and the world size, and never changed after a failure:

  nccl  every rank has a card of its own (world size <= visible cards);
  gloo  the CPU, and ranks that share a card, which NCCL refuses (both
        ranks fail the first collective with "invalid usage" on the card;
        scripts/torch_port_dist_probe.py).

JAX's shardings (`data_sharding`, `replicated`, `shard_graph_batch`,
`:57-80`) have no counterpart: a rank holds its own slice of the data, and
the parameters are replicated, one copy per rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

from ..runtime import resolve_device

__all__ = ["Mesh", "DIST_TIMEOUT_S", "choose_backend", "rank_device",
           "initialize_multihost", "free_port", "shutdown"]

# how long a rank waits in a collective for the others before it raises
DIST_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: n_data * n_model == world_size."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    n_data: int
    n_model: int = 1
    group: object | None = None       # None: the default (world) group

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def staged(self) -> bool:
        """True where the ring exchange goes through host buffers: gloo with
        tensors on a card, whose send and recv take CPU tensors only
        (collectives.py)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(rank: int, device: str | torch.device = "cuda") -> torch.device:
    """cuda:(rank % visible cards), or the CPU when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def choose_backend(device: torch.device, world_size: int) -> str:
    """nccl when every rank has a card of its own, else gloo."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port on localhost that is free now (for tcp://localhost:<port>)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(init_method: str, world_size: int, rank: int,
                         device: str | torch.device = "cuda",
                         n_model: int = 1, timeout_s: float = DIST_TIMEOUT_S) -> Mesh:
    """Join the process group as `rank` of `world_size` and return the mesh.

    init_method: "tcp://host:port" (the JAX CLI's --coordinator host:port)
    or "file://..."; the rank's device is rank_device(rank, device) and the
    backend choose_backend's."""
    if n_model != 1:
        raise NotImplementedError(
            "tensor parallelism (n_model > 1) is not ported; ROADMAP.md "
            "queues it after data parallelism and the halo regime")
    if world_size < 1 or not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = rank_device(rank, device)
    backend = choose_backend(dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    mesh = Mesh(world_size=world_size, rank=rank, device=dev, backend=backend,
                n_data=world_size // n_model, n_model=n_model)
    if mesh.staged:
        print(f"rank {rank}: gloo on {dev}: the ring exchange stages through "
              "pinned host buffers")
    return mesh


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
