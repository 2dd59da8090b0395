"""Max aggregation: the port's plain version against the JAX package.

Tolerances:
  * against the JAX dense path (ops/aggregate.py, impl="dense"): `out` is
    bitwise equal (max selects and does no arithmetic) and `arg` equals the
    dense first-winner slot (ops/aggregate.py:138-140), in f32 and bf16;
  * against the JAX Pallas kernel `tiled_aggregate_max_fwd` in interpret
    mode: `out` within rtol 2**-15 in f32 (its exact mode carries values as
    two bf16 halves, ~2**-16 relative) and equal in bf16; `arg` equal on
    tie-free inputs.

The CUDA wrapper's kernel path needs a card; here every wrapper takes its
plain version because its tensors lie on the CPU. The gradients of the
aggregations are tested in tests/test_torch_port_train_agg.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.ops.aggregate import aggregate_neighbors as jax_aggregate
from gnn_tumor_seg_tpu.ops.aggregate import gather_neighbors
from gnn_tumor_seg_tpu.ops.pallas.gather_agg import tiled_aggregate_max_fwd
from gnn_tumor_seg_tpu.ops.pallas.tiling import build_tiled_aux
from gnn_tumor_seg_tpu_torch.ops.aggregate import aggregate_neighbors
from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (max_aggregate,
                                                         max_aggregate_plain)

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _tables(rng, B=2, N=128, D=12, n_real=100):
    """ELL tables with zero-degree rows, padded slots (index 0) and padded
    nodes past n_real, as ops/graph.ell_from_edges lays them out."""
    deg = rng.integers(0, D + 1, size=(B, N))
    deg[:, n_real:] = 0
    nbr = rng.integers(0, n_real, size=(B, N, D)).astype(np.int32)
    mask = (np.arange(D)[None, None, :] < deg[..., None]).astype(np.float32)
    nbr[mask == 0] = 0
    assert (deg == 0).any() and (mask == 0).any()
    return nbr, mask


def _jax_dense_arg(h, nbr, mask):
    g = gather_neighbors(h, nbr)
    g = jnp.where(mask[..., None] > 0, g, -1e30)
    return np.asarray(jnp.argmax(g, axis=2))


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint16)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_max_matches_jax_dense(dtype):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    nbr, mask = _tables(rng)
    h = rng.normal(size=(2, 128, 20)).astype(np.float32).astype(np_dt)
    want = np.asarray(jax_aggregate(jnp.asarray(h), jnp.asarray(nbr),
                                    jnp.asarray(mask), "max", impl="dense"))
    want_arg = _jax_dense_arg(jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask))
    out, arg = max_aggregate_plain(torch.from_numpy(h.astype(np.float32)).to(t_dt),
                                   torch.from_numpy(nbr), torch.from_numpy(mask))
    assert out.dtype == t_dt and arg.dtype == torch.uint8
    got = out.float().numpy().astype(np_dt)
    assert np.array_equal(_bits(got), _bits(want.astype(np_dt)))
    assert np.array_equal(arg.numpy(), want_arg)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_max_matches_jax_pallas_interpret(dtype):
    np_dt, t_dt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    nbr, mask = _tables(rng, B=1)
    aux = build_tiled_aux(nbr, mask, tile=64)
    # tie-free and exact in bf16: distinct small integers (|v| < 256)
    ints = rng.permutation(np.arange(-240, 240))[:128 * 3].reshape(1, 128, 3)
    normal = rng.normal(size=(1, 128, 17))
    for values, exact_values in ((ints, True), (normal, False)):
        h = values.astype(np.float32).astype(np_dt)
        out_j, arg_j = tiled_aggregate_max_fwd(jnp.asarray(h), aux,
                                               jnp.asarray(mask))
        out, arg = max_aggregate_plain(
            torch.from_numpy(h.astype(np.float32)).to(t_dt),
            torch.from_numpy(nbr), torch.from_numpy(mask))
        got = out.float().numpy()
        want = np.asarray(out_j).astype(np.float32)
        if dtype == "bfloat16" or exact_values:
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -15, atol=0)
        if exact_values:
            assert np.array_equal(arg.numpy(),
                                  np.asarray(arg_j).astype(np.float32).astype(np.uint8))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    nbr, mask = (torch.from_numpy(a) for a in _tables(rng, B=1, N=64, D=8,
                                                        n_real=50))
    h = torch.from_numpy(rng.normal(size=(1, 64, 5)).astype(np.float32))
    before = max_aggregate.launches
    out, arg = max_aggregate(h, nbr, mask)
    out2, none = max_aggregate(h, nbr, mask, with_arg=False)
    want_out, want_arg = max_aggregate_plain(h, nbr, mask)
    assert max_aggregate.launches == before     # no kernel ran
    assert torch.equal(out, want_out) and torch.equal(arg, want_arg)
    assert torch.equal(out2, want_out) and none is None
    assert torch.equal(aggregate_neighbors(h, nbr, mask, "max"), want_out)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_sum_mean_plain_on_cpu_and_refused_off_it(op):
    """sum/mean: plain torch on the CPU, equal to the JAX dense path within
    f32 summation-order rounding (rtol 1e-6); off the CPU the wrapper
    launches its CUDA kernel (tests/test_torch_port_train_agg.py,
    chip_smoke.py) and refuses any other device."""
    rng = np.random.default_rng(3)
    nbr, mask = _tables(rng)
    h = rng.normal(size=(2, 128, 9)).astype(np.float32)
    want = np.asarray(jax_aggregate(jnp.asarray(h), jnp.asarray(nbr),
                                    jnp.asarray(mask), op, impl="dense"))
    got = aggregate_neighbors(torch.from_numpy(h), torch.from_numpy(nbr),
                              torch.from_numpy(mask), op).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="one CUDA device"):
        aggregate_neighbors(torch.empty(2, 128, 9, device="meta"),
                            torch.empty(2, 128, 12, dtype=torch.int32,
                                        device="meta"),
                            torch.empty(2, 128, 12, device="meta"), op)
