"""Aggregation forward and backward for training: the port's plain versions,
through its torch.autograd.Functions on the CPU, against the JAX package.

Tolerances:
  * against the JAX dense path (ops/aggregate.py, impl="dense", whose custom
    VJP `_agg_symmetric` is the scatter-free gather of a symmetric table):
    rtol/atol 1e-6, float32 sums in another order;
  * against the Pallas kernels in interpret mode (impl="pallas": for max
    `tiled_aggregate_max_fwd` and `tiled_max_backward`, for sum/mean
    `tiled_aggregate`, which is also their VJP): rtol/atol 1e-4; their
    exact mode carries each gathered value as two bf16 halves (~2**-16
    relative), as tests/test_pallas_agg.py allows.
Inputs: symmetric, deduplicated tables with zero-degree rows, D=12 and 16,
and one with holes (real slots after padded ones, which the CLI's tables
never have but the semantics allow); max runs on values in quarter steps,
so neighbours tie often and every value is exact in bf16 (the Pallas
kernel then picks the same winners).
The kernels themselves are held bitwise to these plain versions on the card
(chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.ops.aggregate import aggregate_neighbors as jax_aggregate
from gnn_tumor_seg_tpu.ops.aggregate import gather_neighbors
from gnn_tumor_seg_tpu.ops.pallas.tiling import build_tiled_aux
from gnn_tumor_seg_tpu_torch.ops.aggregate import aggregate_neighbors
from gnn_tumor_seg_tpu_torch.ops.graph import ell_from_edges, reciprocal_slots
from gnn_tumor_seg_tpu_torch.ops.kernels import max_agg, sum_agg
from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
    max_aggregate, max_aggregate_backward, max_aggregate_backward_plain,
    max_aggregate_plain)
from gnn_tumor_seg_tpu_torch.ops.kernels.sum_agg import (sum_aggregate,
                                                         sum_aggregate_plain)
from torch_port_tables import punch_holes

N, N_REAL, B, F = 128, 110, 2, 24


def _tables(seed, D):
    """Random undirected deduplicated graphs, degree <= D, some isolated
    nodes, padded rows past N_REAL; plus their reciprocal slots."""
    rng = np.random.default_rng(seed)
    nbrs, masks = [], []
    for _ in range(B):
        live = np.nonzero(rng.random(N_REAL) > 0.1)[0]
        a, c = rng.choice(live, len(live) * D), rng.choice(live, len(live) * D)
        pairs = np.unique(np.sort(np.stack([a[a != c], c[a != c]], 1), 1), axis=0)
        deg = np.zeros(N_REAL, int)
        keep = []
        for x, y in pairs[rng.permutation(len(pairs))]:
            if deg[x] < D and deg[y] < D:
                deg[x] += 1
                deg[y] += 1
                keep.append((x, y))
        e = np.asarray(keep)
        nbr, mask = ell_from_edges(N_REAL, np.r_[e[:, 0], e[:, 1]],
                                   np.r_[e[:, 1], e[:, 0]], n_pad=N, d_pad=D)
        nbrs.append(nbr)
        masks.append(mask)
    nbr, mask = np.stack(nbrs), np.stack(masks)
    assert (mask.sum(-1)[:, :N_REAL] == 0).any()
    return nbr, mask, reciprocal_slots(nbr, mask)


def _holed_tables(seed, D, frac=0.2):
    """_tables with both ends of a fraction of the edges masked off: rows
    then have real slots after padded ones, padded slots keep their
    neighbour ids, and the table stays symmetric."""
    nbr, mask, rslot = _tables(seed, D)
    mask = punch_holes(np.random.default_rng(seed + 1000), nbr, mask, rslot, frac)
    return nbr, mask, reciprocal_slots(nbr, mask)


def _jax_vjp(h, gout, nbr, mask, op, impl, aux=None):
    out, vjp = jax.vjp(lambda x: jax_aggregate(
        x, jnp.asarray(nbr), jnp.asarray(mask), op, impl=impl, tiled=aux),
        jnp.asarray(h))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(gout))[0])


def _port_vjp(h, gout, nbr, mask, rslot, op):
    x = torch.from_numpy(h).requires_grad_(True)
    out = aggregate_neighbors(x, torch.from_numpy(nbr), torch.from_numpy(mask),
                              op, rslot=torch.from_numpy(rslot))
    out.backward(torch.from_numpy(gout))
    return out.detach().numpy(), x.grad.numpy()


def _check_against_jax(op, D, F, holes=False):
    nbr, mask, rslot = (_holed_tables if holes else _tables)(D, D)
    rng = np.random.default_rng(100 + D)
    h = rng.normal(size=(B, N, F)).astype(np.float32)
    if op == "max":
        h = (rng.integers(-6, 6, size=(B, N, F)) / 4.0).astype(np.float32)
    gout = rng.normal(size=(B, N, F)).astype(np.float32)
    out, grad = _port_vjp(h, gout, nbr, mask, rslot, op)

    want_out, want_grad = _jax_vjp(h, gout, nbr, mask, op, "dense")
    np.testing.assert_allclose(out, want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)

    aux = build_tiled_aux(nbr, mask, tile=64)
    assert np.array_equal(np.asarray(aux.rslot), rslot)
    want_out, want_grad = _jax_vjp(h, gout, nbr, mask, op, "pallas", aux)
    np.testing.assert_allclose(out, want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-4)
    if op == "max":
        # ties were resolved: some row's max is attained by two neighbours
        g = np.take_along_axis(h[:, :, None, :].repeat(D, 2),
                               nbr[..., None].repeat(F, 3), axis=1)
        g = np.where(mask[..., None] > 0, g, -np.inf)
        assert ((g == g.max(2, keepdims=True)).sum(2) > 1).any()


@pytest.mark.parametrize("D", [12, 16])
@pytest.mark.parametrize("op", ["max", "sum", "mean"])
def test_forward_and_vjp_match_jax_dense_and_pallas(op, D):
    _check_against_jax(op, D, F)


@pytest.mark.parametrize("D", [12, 16])
@pytest.mark.parametrize("op,width", [
    pytest.param(op, width, id=f"{op}-{width}" if op != "max" else str(width))
    for op in ("max", "sum", "mean") for width in (3, 20, 36)])
def test_max_vjp_matches_jax_at_kernel_vector_widths(op, width, D):
    """The max forward and backward, and sum and mean (their forward is
    also their backward), at the widths that give the kernels vectors of 1
    (F=3) and 4 (F=20, the first GSpool layer; F=36, no multiple of 8),
    against the same JAX references and tolerances."""
    _check_against_jax(op, D, width)


@pytest.mark.parametrize("op", ["max", "sum", "mean"])
def test_vjp_matches_jax_on_a_table_with_holes(op):
    """On a table with real slots after padded ones, forward and backward
    against the same JAX references and tolerances; for max, the winner
    slot is also the JAX dense path's first winner (an original slot d, not
    a position among the real slots)."""
    _check_against_jax(op, 12, F, holes=True)
    if op == "max":
        nbr, mask, _ = _holed_tables(12, 12)
        h = (np.random.default_rng(5).integers(-6, 6, size=(B, N, F)) / 4.0
             ).astype(np.float32)
        g = jnp.where(jnp.asarray(mask)[..., None] > 0,
                      gather_neighbors(jnp.asarray(h), jnp.asarray(nbr)), -1e30)
        _, arg = max_aggregate_plain(torch.from_numpy(h), torch.from_numpy(nbr),
                                     torch.from_numpy(mask))
        want = np.asarray(jnp.argmax(g, axis=2))
        assert np.array_equal(arg.numpy(), want)
        # some winner sits after a hole, where its slot and its position
        # among the real slots differ
        pos = np.cumsum(mask > 0, axis=2) - 1
        won_pos = np.take_along_axis(pos, want.astype(np.int64), axis=2)
        assert ((won_pos != want) & (mask.sum(2, keepdims=True) > 0)).any()


@pytest.mark.parametrize("op", ["max", "max_bwd", "sum", "mean"])
def test_kernels_refuse_graphs_past_32_bit_offsets(op, monkeypatch):
    """The kernels index a graph's rows with 32-bit integers: at N*F >=
    2**31 the wrappers raise ValueError before they build anything (meta
    tensors: no memory, no card)."""
    def no_build():
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(max_agg, "build", no_build)
    monkeypatch.setattr(sum_agg, "build", no_build)
    n = 2 ** 23
    h = torch.empty(1, n, 256, device="meta")
    nbr = torch.empty(1, n, 12, dtype=torch.int32, device="meta")
    mask = torch.empty(1, n, 12, device="meta")
    with pytest.raises(ValueError, match=r"N\*F = 2147483648 >= 2\*\*31"):
        if op == "max":
            max_aggregate(h, nbr, mask)
        elif op == "max_bwd":
            max_aggregate_backward(h, torch.empty(h.shape, dtype=torch.uint8,
                                                  device="meta"), nbr, mask,
                                   torch.empty_like(nbr))
        else:
            sum_aggregate(h, nbr, mask, op == "mean")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_plain_versions_on_cpu(dtype):
    """On a CPU tensor every wrapper takes its plain version and counts no
    launch; the backward keeps gout's dtype (bf16 in "fast" training)."""
    nbr, mask, rslot = (torch.from_numpy(a) for a in _tables(7, 12))
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32)).to(dtype)
    gout = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32)).to(dtype)
    before = (max_aggregate_backward.launches, sum_aggregate.launches)
    _, arg = max_aggregate_plain(h, nbr, mask)
    grad = max_aggregate_backward(gout, arg, nbr, mask, rslot)
    assert grad.dtype == dtype
    assert torch.equal(grad, max_aggregate_backward_plain(gout, arg, nbr, mask, rslot))
    for mean in (False, True):
        got = sum_aggregate(h, nbr, mask, mean)
        assert got.dtype == dtype
        assert torch.equal(got, sum_aggregate_plain(h, nbr, mask, mean))
    assert (max_aggregate_backward.launches, sum_aggregate.launches) == before


def test_max_gradient_needs_rslot():
    nbr, mask, _ = (torch.from_numpy(a) for a in _tables(9, 12))
    h = torch.zeros(B, N, F, requires_grad=True)
    with pytest.raises(ValueError, match="reciprocal slots"):
        aggregate_neighbors(h, nbr, mask, "max")
    with torch.no_grad():
        aggregate_neighbors(h, nbr, mask, "max")     # inference needs none


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_weighted_sum_mean_match_jax_on_cpu(op):
    """Edge-weighted sum/mean through the weighted-combine Function, whose
    plain versions run on the CPU, against the JAX dense weighted path
    (rtol/atol 1e-6, forward and the gradient of h; 1e-5 for the weights'
    gradient, a dot over F in another order)."""
    nbr, mask, rslot = _tables(11, 12)
    rng = np.random.default_rng(12)
    h = rng.normal(size=(B, N, F)).astype(np.float32)
    # symmetric weights (w_uv == w_vu), as the JAX VJP assumes and the
    # intensity weights of data/graph_build.py are
    pair = rng.random((B, N, N)).astype(np.float32)
    pair = pair + pair.transpose(0, 2, 1)
    w = np.take_along_axis(pair, nbr.astype(np.int64), axis=2) * mask
    gout = rng.normal(size=(B, N, F)).astype(np.float32)
    out, vjp = jax.vjp(lambda x, ww: jax_aggregate(
        x, jnp.asarray(nbr), jnp.asarray(mask), op, impl="dense",
        edge_weight=ww), jnp.asarray(h), jnp.asarray(w))
    want_h, want_w = vjp(jnp.asarray(gout))
    x = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = aggregate_neighbors(x, torch.from_numpy(nbr), torch.from_numpy(mask),
                              op, rslot=torch.from_numpy(rslot), edge_weight=wt)
    got.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_h),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)
