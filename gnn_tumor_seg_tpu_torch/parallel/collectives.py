"""The collectives of the distributed regimes, each an autograd Function
where a gradient passes through it (port-only: the JAX package's XLA
inserts these itself under shard_map and GSPMD).

  all_gather_rows(x, mesh)   every rank's rows, concatenated in rank order.
                             Backward: the cotangents summed over ranks,
                             then the rank's own slice (JAX: "the all_gather
                             transpose reduce-scatters the cotangents",
                             parallel/halo.py:456-461).
  ring_exchange(h, W, mesh)  the two ring ppermutes of JAX `extend_halo`
                             (halo.py:336-350): (the previous rank's last W
                             rows, the next rank's first W rows), as one
                             dist.batch_isend_irecv. Backward: each halo
                             block's cotangent goes back to its home rank,
                             which adds it to its own rows' gradient.
  all_reduce_sum(x, mesh)    the sum over ranks, the same on every rank.
                             Backward: identity, since every rank holds the
                             same replicated objective (the global loss).
  all_reduce_grads(params)   sums the parameters' gradients over ranks in
                             place (one flat buffer, one collective).
  copy_to_model(x, mesh)     tensor parallelism, over the model group: the
                             identity; backward, the cotangents summed over
                             the model ranks. It goes on a replicated input
                             of a column-parallel product, whose gradient
                             each rank holds only in part.
  gather_from_model(x, mesh) the model ranks' column blocks of x,
                             concatenated on the last axis in model-rank
                             order; backward, the rank's own block of the
                             (replicated) cotangent.
  gather_leaf(x, axis, mesh) the same without a gradient, on any axis: a
                             sharded leaf (parameter or optimizer moment)
                             made whole for a checkpoint.

Gloo's send and recv take CPU tensors only: on the card, batch_isend_irecv
of CUDA tensors over gloo aborts the process, where all_reduce, all_gather
and broadcast take them (scripts/torch_port_dist_probe.py, PERF.md §6, PR
12). So on a gloo group whose tensors lie on a card (`Mesh.staged`: ranks
that share one card) the ring exchange stages explicitly through pinned
host buffers (mesh.py says so when the rank joins); every other
collective, and everything on NCCL and on the CPU, takes the tensors as
they are. A world of one rank still runs the collectives, so world size 1
exercises the backend.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["all_gather_rows", "ring_exchange", "all_reduce_sum",
           "all_reduce_grads", "all_reduce_max_int", "all_gather_host",
           "launches_by_rank", "copy_to_model", "gather_from_model",
           "gather_leaf"]

def _to_wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """What send takes: t contiguous, on the host when the mesh stages."""
    if not mesh.staged:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _empty_wire(shape, like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------ primitives


def _all_reduce(x: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order ([n, ...] per
    rank -> [world * n, ...] for dim 0)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _exchange(to_next: torch.Tensor, to_prev: torch.Tensor, mesh: Mesh):
    """Send to_next to rank + 1 and to_prev to rank - 1 (on a ring); return
    (from_prev, from_next): what rank - 1 sent to its next and what rank + 1
    sent to its previous. Tags keep the two streams apart when the previous
    and the next rank are one (two ranks); NCCL, which ignores tags, matches
    the operations in this order."""
    if mesh.world_size == 1:
        return to_next.clone(), to_prev.clone()
    nxt = (mesh.rank + 1) % mesh.world_size
    prv = (mesh.rank - 1) % mesh.world_size
    s_next, s_prev = _to_wire(to_next, mesh), _to_wire(to_prev, mesh)
    r_prev = _empty_wire(to_next.shape, to_next, mesh)
    r_next = _empty_wire(to_prev.shape, to_prev, mesh)
    ops = [dist.P2POp(dist.isend, s_next, nxt, mesh.group, 0),
           dist.P2POp(dist.isend, s_prev, prv, mesh.group, 1),
           dist.P2POp(dist.irecv, r_prev, prv, mesh.group, 0),
           dist.P2POp(dist.irecv, r_next, nxt, mesh.group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return r_prev.to(to_next.device), r_next.to(to_prev.device)


# ------------------------------------------------------------ autograd


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n
        total = _all_reduce(g, mesh)
        return total[mesh.rank * n:(mesh.rank + 1) * n], None


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, mesh):
        ctx.mesh, ctx.W, ctx.shape = mesh, W, h.shape
        return _exchange(h[-W:], h[:W], mesh)

    @staticmethod
    def backward(ctx, g_left, g_right):
        # g_left belongs to the previous rank's last W rows, g_right to the
        # next rank's first W rows: send each home, receive this rank's own
        mesh, W = ctx.mesh, ctx.W
        g_first, g_last = _exchange(g_right.contiguous(),
                                    g_left.contiguous(), mesh)
        grad = torch.zeros(ctx.shape, dtype=g_left.dtype, device=g_left.device)
        grad[:W] += g_first
        grad[-W:] += g_last
        return grad, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return _all_gather(x, mesh, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [n, ...] on every rank -> [world * n, ...], rank r's rows at
    [r * n, (r + 1) * n)."""
    return _AllGatherRows.apply(x, mesh)


def ring_exchange(h: torch.Tensor, W: int, mesh: Mesh):
    """h [shard, F] -> (left [W, F], right [W, F]): the previous rank's last
    W rows and the next rank's first W rows (ring order, so rank 0's left
    comes from the last rank). 1 <= W <= shard."""
    if not 1 <= W <= h.shape[0]:
        raise ValueError(f"halo width {W} outside [1, {h.shape[0]}]")
    return _RingExchange.apply(h, W, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over ranks (differentiable; the backward is identity)."""
    return _AllReduceSum.apply(x, mesh)


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x itself; its gradient summed over `mesh`'s model group."""
    return _CopyToModel.apply(x, mesh.along("model"))


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [..., n] on every model rank -> [..., M * n], model rank m's block
    at columns [m * n, (m + 1) * n)."""
    return _GatherFromModel.apply(x, mesh.along("model"))


# ------------------------------------------------------------ no gradient


@torch.no_grad()
def gather_leaf(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """A leaf sharded on `axis` over `mesh`'s model group, made whole on
    every model rank."""
    return _all_gather(x, mesh.along("model"), dim=axis)


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's .grad over ranks, in place, with one collective
    over a flat buffer (a parameter without a gradient counts as zeros)."""
    params = list(params)
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    flat = _all_reduce(flat, mesh)
    offset = 0
    for p in params:
        n = p.numel()
        g = flat[offset:offset + n].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        offset += n


def all_reduce_max_int(values, mesh: Mesh) -> list[int]:
    """Elementwise max of a list of ints over ranks."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor(list(values), dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return [int(v) for v in t.cpu()]


def all_gather_host(x, mesh: Mesh):
    """A small host array from every rank -> numpy [world, ...] (float64)."""
    import numpy as np

    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.as_tensor(np.asarray(x, np.float64), device=dev)
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).cpu().numpy()


@contextlib.contextmanager
def launches_by_rank(mesh: Mesh):
    """Kernel launches of a block on every rank: `with launches_by_rank(mesh)
    as counts:` leaves in `counts` one dict per rank, in rank order, of the
    launches each rank's wrappers counted inside the block (a collective
    when the block ends: every rank must run it)."""
    from ..ops.kernels import launch_counts

    counts: list[dict[str, int]] = []
    start = launch_counts()
    yield counts
    end = launch_counts()
    names = sorted(end)
    rows = all_gather_host([end[k] - start[k] for k in names], mesh)
    counts.extend({k: int(v) for k, v in zip(names, row)} for row in rows)
