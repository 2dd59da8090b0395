"""Refinement CNN: the port against the JAX CnnRefinementNet on shared weights.

A 20x24x16x8 NDHWC input; the JAX parameters (DHWIO) cross through
convert.cnn_params_from_jax (OIDHW). Tolerance in "exact": rtol 1e-4,
atol 1e-5 (float32 convolutions of 125 x C taps summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gnn_tumor_seg_tpu.models.refine_cnn import CnnRefinementNet as JaxCnn
from gnn_tumor_seg_tpu_torch.convert import cnn_params_from_jax, cnn_params_to_jax
from gnn_tumor_seg_tpu_torch.ops.precision import (get_precision_mode,
                                                   precision_scope,
                                                   set_precision_mode)


def _shared():
    jnet = JaxCnn(8, 4, [16])
    jparams = jnet.init(jax.random.PRNGKey(0))
    net = cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)).eval()
    x = np.random.default_rng(0).normal(size=(1, 20, 24, 16, 8)).astype(np.float32)
    return jnet, jparams, net, x


def test_cnn_exact_matches_jax():
    jnet, jparams, net, x = _shared()
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    with precision_scope("exact"), torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 20, 24, 16, 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cnn_params_round_trip_and_layout():
    _, jparams, net, _ = _shared()
    assert tuple(net.w0.shape) == (16, 8, 5, 5, 5)          # OIDHW
    back = cnn_params_to_jax(net)
    for layer in ("conv0", "conv1"):
        for key in ("w", "b"):
            assert np.array_equal(np.asarray(jparams[layer][key]), back[layer][key])


def test_cnn_fast_runs_bf16_and_returns_f32():
    """"fast" computes in bf16 and returns float32 logits near the exact ones
    (bf16 keeps ~3 significant digits: 5e-2 of the logits' scale)."""
    _, _, net, x = _shared()
    with torch.inference_mode():
        with precision_scope("exact"):
            exact = net(torch.from_numpy(x))
        with precision_scope("fast"):
            fast = net(torch.from_numpy(x))
    assert fast.dtype == torch.float32
    assert (fast - exact).abs().max() <= 5e-2 * exact.abs().max()


def test_exact_mode_switches_tf32_off():
    """Entering "exact" switches both TF32 flags off; leaving the scope
    restores them; set_precision_mode("exact") switches them off for good."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with precision_scope("exact"):
        assert get_precision_mode() == "exact"
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    set_precision_mode("exact")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
