"""GAT: the fused attention module and the GAT model of the port against the
JAX package on the same inputs.

Graphs: two random graphs of 220 nodes (avg degree 6) batched to B=2, N=256,
so 36 padded rows per graph have no neighbour; the tables are symmetric and
carry the reciprocal slots. Inputs come from numpy seeds. Tolerances:
  * plain fused attention (forward, and its VJP through FusedGatAttention)
    against the JAX dense reference in float32: rtol/atol 1e-5 (float32
    sums in another order; the same exp);
  * against the JAX Pallas kernel `fused_gat_attention` in interpret mode:
    3e-3 forward, 5e-3 gradients, the JAX suite's own tolerances
    (tests/test_pallas_agg.py), since its "exact" mode carries values as two
    bf16 halves (~2**-16 relative);
  * GAT logits and every parameter gradient of the weighted cross-entropy
    against the JAX GAT (dense) in "exact": logits rtol/atol 1e-5, each
    gradient within 1e-4 of its tensor's largest entry (an attention
    vector's gradient sums softmax-backward terms over every edge, which
    largely cancel: one seed of three gives 3e-5, the rest stay below 3e-6);
  * "fast" (bf16 activations in both packages, rounded at different
    places, and the JAX dense path also computes its softmax in bf16):
    logits within 5e-2 of their scale and 98% of the real nodes with the
    same argmax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.gat import GAT as JaxGAT
from gnn_tumor_seg_tpu.ops.graph import batch_graphs as jax_batch_graphs
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.fused_gat import fused_gat_attention as jax_fused
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.train.losses import weighted_cross_entropy as jax_wce
from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.convert import gat_params_from_jax, gat_params_to_jax
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.models.gat import GatConv
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.kernels import fused_gat
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

SLOPE = 0.2
CLASS_WEIGHTS = np.asarray([0.1, 1, 2, 2], np.float32)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    jgs, tgs = [], []
    for _ in range(2):
        feats, src, dst, labels = random_graph(rng, 220, avg_deg=6, f_dim=20)
        jgs.append(jax_graph_from_arrays(feats, src, dst, labels).with_tiled_aux())
        tgs.append(graph_from_arrays(feats, src, dst, labels, rslot=True))
    jg, tg = jax_batch_graphs(jgs), batch_graphs(tgs)
    assert np.array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
    assert np.array_equal(tg.nbr_mask.numpy(), np.asarray(jg.nbr_mask))
    assert (tg.nbr_mask.sum(-1) == 0).sum() >= 72      # rows without a neighbour
    return jg, tg


def _inputs(tg, H, F, seed):
    B, N, _ = tg.nbr.shape
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"z": arr(B, N, H, F), "el": arr(B, N, H), "er": arr(B, N, H),
            "res": arr(B, N, H * F), "bias": arr(H * F)}


def _jax_reference(jg, act, with_res):
    """The JAX dense attention (tests/test_pallas_agg.py) and the GAT
    epilogue (models/gat.py:147-159)."""
    def ref(z, el, er, res, bias):
        B, N, H, F = z.shape
        gather = jax.vmap(lambda a, i: a[i])
        el_src = gather(el, jg.nbr)
        e = jax.nn.leaky_relu(el_src + er[:, :, None, :], SLOPE)
        e = jnp.where(jg.nbr_mask[..., None] > 0, e, -1e30)
        e = e - jax.lax.stop_gradient(jnp.max(e, axis=2, keepdims=True))
        w = jnp.exp(e) * jg.nbr_mask[..., None]
        alpha = w / jnp.maximum(jnp.sum(w, axis=2, keepdims=True), 1e-20)
        zsrc = gather(z.reshape(B, N, H * F), jg.nbr).reshape(B, N, -1, H, F)
        out = jnp.einsum("bndh,bndhf->bnhf", alpha, zsrc)
        if with_res:
            out = out + res.reshape(B, N, H, F)
        out = out + bias.reshape(H, F)
        return jax.nn.elu(out) if act == "elu" else out
    return ref


def _port_vjp(tg, x, act, with_res, ct):
    """(out, grads of z, el, er, res, bias) through FusedGatAttention on
    the CPU, i.e. through the plain versions of the three kernels."""
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    out = fused_gat.fused_gat_attention(
        t["z"], t["el"], t["er"], t["bias"], tg.nbr, tg.nbr_mask, tg.rslot,
        SLOPE, act, t["res"] if with_res else None)
    out.backward(torch.from_numpy(ct))
    names = ("z", "el", "er", "res", "bias") if with_res else ("z", "el", "er", "bias")
    return out.detach().numpy(), {k: t[k].grad.numpy() for k in names}


@pytest.mark.parametrize("with_res", [False, True], ids=["no_res", "res"])
@pytest.mark.parametrize("act", [None, "elu"], ids=["none", "elu"])
@pytest.mark.parametrize("H,F", [(1, 4), (3, 16)])
def test_fused_attention_and_vjp_match_jax_dense(graphs, H, F, act, with_res):
    jg, tg = graphs
    x = _inputs(tg, H, F, seed=10 * H + F)
    ref = _jax_reference(jg, act, with_res)
    want, vjp = jax.vjp(ref, *(jnp.asarray(x[k]) for k in
                               ("z", "el", "er", "res", "bias")))
    ct = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    got, grads = _port_vjp(tg, x, act, with_res, ct)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    want_grads = dict(zip(("z", "el", "er", "res", "bias"), vjp(jnp.asarray(ct))))
    for name, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(want_grads[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("H,F", [(1, 4), (3, 16)])
def test_fused_attention_matches_jax_interpret_kernel(graphs, H, F):
    jg, tg = graphs
    x = _inputs(tg, H, F, seed=7 + H)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    with jax_precision("exact"):
        want, vjp = jax.vjp(lambda z, el, er, res, bias: jax_fused(
            z, el, er, jg.tiled, jg.nbr_mask, SLOPE, "elu", res, bias),
            jx["z"], jx["el"], jx["er"], jx["res"], jx["bias"])
        ct = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
        want_grads = dict(zip(("z", "el", "er", "res", "bias"),
                              vjp(jnp.asarray(ct))))
    got, grads = _port_vjp(tg, x, "elu", True, ct)
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-3, atol=3e-3)
    for name, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(want_grads[name]), rtol=5e-3,
                                   atol=5e-3, err_msg=name)


def test_saved_alpha_and_sign_mask(graphs):
    """save=True returns alpha (each real row sums to 1 per head, rows
    without a neighbour are 0) and the uint8 sign mask of the real slots;
    save=False returns neither, with the same output."""
    _, tg = graphs
    x = {k: torch.from_numpy(v) for k, v in _inputs(tg, 3, 16, seed=3).items()}
    args = (x["z"], x["el"], x["er"], tg.nbr, tg.nbr_mask, SLOPE, "elu",
            x["res"], x["bias"])
    out, alpha, pos = fused_gat.fused_gat_forward(*args, save=True)
    out2, none_a, none_p = fused_gat.fused_gat_forward(*args, save=False)
    assert torch.equal(out, out2) and none_a is None and none_p is None
    B, N, D = tg.nbr.shape
    a = alpha.reshape(B, N, D, 3)
    has = (tg.nbr_mask.sum(-1) > 0)[..., None]
    sums = a.sum(2)
    assert torch.allclose(sums[has.expand_as(sums)], torch.ones(()), atol=1e-6)
    assert not a[~has[..., 0]].any()
    el_src = torch.gather(x["el"], 1, tg.nbr.long().reshape(B, N * D, 1)
                          .expand(B, N * D, 3)).reshape(B, N, D, 3)
    want_pos = ((el_src + x["er"][:, :, None]) >= 0) & (tg.nbr_mask > 0)[..., None]
    assert pos.dtype == torch.uint8 and torch.equal(pos.bool(),
                                                    want_pos.reshape(B, N, -1))
    assert fused_gat.fused_gat_forward.launches == 0    # plain on the CPU


def _jax_gat(heads, residuals, widths, key=1):
    jmodel = JaxGAT(20, widths, 4, heads=heads, residuals=residuals)
    jparams = jmodel.init(jax.random.PRNGKey(key))
    model = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                residuals)
    return jmodel, jparams, model


# (heads, residuals, widths): a projected residual (w_res, 3*8 -> 2*8) and an
# identity residual (2*8 -> 2*8)
CONFIGS = {"w_res": ([3, 2], [False, True], [8, 8]),
           "identity_res": ([2, 2], [False, True], [8, 8])}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_gat_logits_and_gradients_match_jax(graphs, config):
    jg, tg = graphs
    heads, residuals, widths = CONFIGS[config]
    jmodel, jparams, model = _jax_gat(heads, residuals, widths)
    has_w_res = [layer.w_res is not None for layer in model.layers]
    assert has_w_res == [False, config == "w_res", False]

    def jax_loss(p):
        logits = jmodel.apply(p, jg, impl="dense")
        return jax_wce(logits, jg.labels, jnp.asarray(CLASS_WEIGHTS),
                       jg.node_mask), logits

    with jax_precision("exact"):
        (_, want_logits), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
            jparams)
    with precision_scope("exact"):
        logits = model(tg, train=True)
        loss = weighted_cross_entropy(logits, tg.labels,
                                      torch.from_numpy(CLASS_WEIGHTS), tg.node_mask)
        grads = torch.autograd.grad(loss, model.jax_parameters())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(want) == len(grads) == 12 + has_w_res.count(True)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_gat_fast_mode_close_to_jax(graphs):
    jg, tg = graphs
    jmodel, jparams, model = _jax_gat(*CONFIGS["w_res"])
    n = 220
    with jax_precision("fast"):
        want = np.asarray(jmodel.apply(jparams, jg, impl="dense"))[:, :n]
    with precision_scope("fast"), torch.inference_mode():
        got = model(tg).numpy()[:, :n]
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_attention_dropout_path_on_the_cpu(graphs):
    """attn_drop > 0 in training takes the decomposed path (the slot gather
    and the weighted combine, here their plain versions; kernels 9 and 7 on
    the card): without dropout it equals the fused path, and with it the
    output changes."""
    _, tg = graphs
    layer = GatConv(20, 8, 3, residual=True, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.bias.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
        fused = layer(tg, tg.feats, activation=True)
        B, N, _ = tg.feats.shape
        h = tg.feats
        z = (h @ layer.w).reshape(B, N, 3, 8)
        el = torch.einsum("bnhf,hf->bnh", z, layer.attn_l)
        er = torch.einsum("bnhf,hf->bnh", z, layer.attn_r)
        dense = layer._decomposed(tg, z, el, er, h @ layer.w_res, layer.bias,
                                  "elu", SLOPE, 0.0, None)
        dropped = layer(tg, tg.feats, activation=True, attn_drop=0.5,
                        generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(dense, fused, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(dropped).all() and not torch.allclose(dropped, fused)


def test_factory_builds_gat_with_jax_layout():
    hp = HyperParams(layer_sizes=[16, 16], gat_heads=[4, 3],
                     gat_residuals=[False, True])
    model = init_graph_net("GAT", hp, torch.Generator().manual_seed(0))
    assert model.specs == [(20, 16, 4, False), (64, 16, 3, True), (48, 4, 1, False)]
    back = gat_params_from_jax(gat_params_to_jax(model), hp.gat_residuals)
    for a, b in zip(model.jax_parameters(), back.jax_parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gat_heads"):
        init_graph_net("GAT", HyperParams(layer_sizes=[16]))
    for layer in model.layers:
        for name in layer.keys:
            t = getattr(layer, name).detach()
            if name == "bias":
                assert not t.any()
                continue
            bound = math.sqrt(2.0) * math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
            assert t.abs().max() <= bound and t.abs().max() > 0.5 * bound
