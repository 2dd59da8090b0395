"""Child process of tests/test_torch_port_gat.py::test_plain_forward_first_call_after_bf16_conv.

Runs, in a fresh process and in this order, what used to make the first
plain GAT forward of a test worker differ from the later ones: a bf16
refinement-CNN forward on the CPU, a JAX computation on the same process
(the dense reference attention), then fused_gat_forward_plain twice on the
GAT test's H=1, F=4 inputs. Prints one JSON line: the largest difference
between the two calls and each call's largest difference from a float64
numpy reference, for out and alpha.

    python tests/torch_port_first_exp.py
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gnn_tumor_seg_tpu_torch.data.synthetic import random_graph  # noqa: E402
from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet  # noqa: E402
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays  # noqa: E402
from gnn_tumor_seg_tpu_torch.ops.kernels import fused_gat  # noqa: E402
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope  # noqa: E402

SLOPE = 0.2


def reference64(z, el, er, nbr, mask, bias):
    """out and alpha of the attention in float64 numpy (no residual, no
    activation)."""
    z, el, er, bias = (np.asarray(a, np.float64) for a in (z, el, er, bias))
    B, N, H, F = z.shape
    p = np.take_along_axis(el, nbr.reshape(B, -1)[..., None], 1).reshape(
        B, N, -1, H) + er[:, :, None, :]
    valid = (mask > 0)[..., None]
    e = np.where(valid, np.where(p >= 0, p, p * SLOPE), -np.inf)
    mx = e.max(axis=2, keepdims=True)
    w = np.where(valid, np.exp(e - np.where(np.isfinite(mx), mx, 0.0)), 0.0)
    alpha = w / np.maximum(w.sum(axis=2, keepdims=True), 1e-20)
    zs = np.take_along_axis(z.reshape(B, N, H * F),
                            nbr.reshape(B, -1)[..., None], 1).reshape(
        B, N, -1, H, F)
    out = np.einsum("bndh,bndhf->bnhf", alpha, zs) + bias.reshape(H, F)
    return out, alpha.reshape(B, N, -1)


def main():
    net = CnnRefinementNet(8, 4, [16], torch.Generator().manual_seed(0)).eval()
    x = np.random.default_rng(0).normal(size=(1, 20, 24, 16, 8)).astype(np.float32)
    with torch.inference_mode(), precision_scope("fast"):
        net(torch.from_numpy(x))

    rng = np.random.default_rng(0)
    tg = batch_graphs([graph_from_arrays(*random_graph(rng, 220, avg_deg=6,
                                                       f_dim=20))
                       for _ in range(2)])
    B, N, _ = tg.nbr.shape
    r = np.random.default_rng(14)
    z, el, er = (r.normal(size=s).astype(np.float32)
                 for s in ((B, N, 1, 4), (B, N, 1), (B, N, 1)))
    bias = r.normal(size=4).astype(np.float32)
    nbr, mask = tg.nbr.numpy(), tg.nbr_mask.numpy()

    @jax.jit
    def dense(z, el, er):
        p = jax.vmap(lambda a, i: a[i])(el, jnp.asarray(nbr)) + er[:, :, None]
        e = jnp.where(jnp.asarray(mask)[..., None] > 0,
                      jax.nn.leaky_relu(p, SLOPE), -1e30)
        return jax.nn.softmax(e, axis=2)
    jax.block_until_ready(dense(jnp.asarray(z), jnp.asarray(el), jnp.asarray(er)))

    t = [torch.from_numpy(a) for a in (z, el, er, bias)]
    calls = [fused_gat.fused_gat_forward_plain(t[0], t[1], t[2], tg.nbr,
                                               tg.nbr_mask, SLOPE, None, None,
                                               t[3])
             for _ in range(2)]
    out64, alpha64 = reference64(z, el, er, nbr, mask, bias)
    res = {
        "out_between_calls": float((calls[0][0] - calls[1][0]).abs().max()),
        "alpha_between_calls": float((calls[0][1] - calls[1][1]).abs().max()),
        "out_vs_f64": [float(np.abs(c[0].double().numpy() - out64).max())
                       for c in calls],
        "alpha_vs_f64": [float(np.abs(c[1].double().numpy() - alpha64).max())
                         for c in calls],
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
