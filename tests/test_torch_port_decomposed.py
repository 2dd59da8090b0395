"""The decomposed attention and weighted-combine modules of the port against
the JAX package on the same inputs: the slot gather, the weighted sum and
its gradients, SDDMM, weighted GSmean/GSgcn, and GAT under attention dropout.

Graphs: two random graphs of 220 nodes (avg degree 6) batched to B=2, N=256,
so 36 padded rows per graph have no neighbour; the tables are symmetric and
carry the reciprocal slots. Inputs come from numpy seeds; on the CPU every
kernel wrapper takes its plain version. Tolerances:
  * against the JAX Pallas kernels in interpret mode (`slot_gather`,
    `tiled_weighted_sum`, `sddmm(impl="pallas")`), the JAX suite's own
    (tests/test_pallas_agg.py:124-200): 2e-3 forward and 3e-3 gradient for
    the slot gather, 3e-3 forward and 5e-3 gradients for the weighted sum,
    3e-3 for SDDMM; their "exact" mode carries values as two bf16 halves
    (~2**-16 relative);
  * against the JAX dense gather: the slot gather's forward exactly (a
    copy); its gradient, and everything else against the JAX dense
    references, within rtol/atol 1e-5 (float32 sums in another order);
  * the weighted sum's custom backward against torch autograd through its
    own plain version, with weights that are not symmetric: 1e-5;
  * weighted GSmean and GSgcn against the JAX GraphSage (dense, "exact"):
    logits rtol/atol 1e-5, each parameter gradient within 1e-5 of its
    tensor's largest entry;
  * GAT with attention dropout, both packages drawing the same keep-mask
    (JAX's, drawn as models/gat.py:80,131 draws it): logits rtol/atol 1e-5
    and each parameter gradient within 1e-4 of its tensor's largest entry
    against the JAX dense path (tests/test_torch_port_gat.py:14-18);
    against the JAX Pallas path in interpret mode, 5e-3 and 2e-2, the JAX
    suite's tolerances for that path (tests/test_pallas_agg.py:173-185).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.models.gat import GAT as JaxGAT
from gnn_tumor_seg_tpu.models.sage import GraphSage as JaxGraphSage
from gnn_tumor_seg_tpu.ops.graph import batch_graphs as jax_batch_graphs
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu.ops.pallas.slot_gather import slot_gather as jax_slot_gather
from gnn_tumor_seg_tpu.ops.pallas.weighted_sum import tiled_weighted_sum
from gnn_tumor_seg_tpu.ops.sddmm import sddmm as jax_sddmm
from gnn_tumor_seg_tpu.train.losses import weighted_cross_entropy as jax_wce
from gnn_tumor_seg_tpu_torch.convert import gat_params_from_jax, gnn_params_from_jax
from gnn_tumor_seg_tpu_torch.data.graph_build import intensity_edge_weights
from gnn_tumor_seg_tpu_torch.models import gat as gat_module
from gnn_tumor_seg_tpu_torch.ops.aggregate import aggregate_neighbors
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.kernels import slot_gather, weighted_sum
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.ops.sddmm import sddmm
from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy
from torch_port_tables import punch_holes

CLASS_WEIGHTS = np.asarray([0.1, 1, 2, 2], np.float32)


@pytest.fixture(scope="module")
def graphs():
    """JAX (with its tiled tables) and port graphs of the same two random
    graphs, with symmetric intensity edge weights (sigma 0.5, so the
    weights spread over (0, 1])."""
    rng = np.random.default_rng(0)
    jgs, tgs = [], []
    for _ in range(2):
        feats, src, dst, labels = random_graph(rng, 220, avg_deg=6, f_dim=20)
        w = intensity_edge_weights(feats, src, dst, sigma=0.5)
        jgs.append(jax_graph_from_arrays(feats, src, dst, labels,
                                         edge_weights=w).with_tiled_aux())
        tgs.append(graph_from_arrays(feats, src, dst, labels, edge_weights=w,
                                     rslot=True))
    jg, tg = jax_batch_graphs(jgs), batch_graphs(tgs)
    assert np.array_equal(tg.nbr.numpy(), np.asarray(jg.nbr))
    assert np.array_equal(tg.edge_weight.numpy(), np.asarray(jg.edge_weight))
    assert np.array_equal(tg.rslot.numpy(), np.asarray(jg.tiled.rslot))
    assert (tg.nbr_mask.sum(-1) == 0).sum() >= 72      # rows without a neighbour
    return jg, tg


def _dense_gather(x, nbr):
    return jax.vmap(lambda a, i: a[i])(x, nbr)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 8])
def test_slot_gather_matches_jax(graphs, W):
    jg, tg = graphs
    B, N, D = tg.nbr.shape
    x = _normal(W, B, N, W)
    ct = _normal(W + 100, B, N, D, W)
    t = torch.from_numpy(x).requires_grad_()
    got = slot_gather.gather_slots(t, tg.nbr, tg.nbr_mask, tg.rslot)
    got.backward(torch.from_numpy(ct))
    got, grad = got.detach().numpy(), t.grad.numpy()

    def dense(v):
        return _dense_gather(v, jg.nbr) * jg.nbr_mask[..., None]

    want, vjp = jax.vjp(dense, jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-5, atol=1e-5)
    with jax_precision("exact"):
        want, vjp = jax.vjp(lambda v: jax_slot_gather(v, jg.tiled, jg.nbr_mask),
                            jnp.asarray(x))
        want_grad = vjp(jnp.asarray(ct))[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=3e-3, atol=3e-3)
    assert slot_gather.slot_gather.launches == 0     # plain versions on the CPU
    assert slot_gather.slot_gather_backward.launches == 0


def _jax_weighted_ref(jg, H, F):
    def ref(v, w):
        B, N, D = jg.nbr.shape
        src = _dense_gather(v.reshape(B, N, H * F), jg.nbr).reshape(B, N, D, H, F)
        return jnp.einsum("bndh,bndhf->bnhf", w * jg.nbr_mask[..., None], src)
    return ref


def _port_weighted_vjp(tg, values, weights, ct, fn=None):
    v = torch.from_numpy(values).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    if fn is None:
        out = weighted_sum.weighted_combine(v, w, tg.nbr, tg.nbr_mask, tg.rslot)
    else:
        out = fn(v, w)
    out.backward(torch.from_numpy(ct))
    return out.detach().numpy(), v.grad.numpy(), w.grad.numpy()


# the model's widths, then F = 3, 6, 36 at H = 1 and 2: the widths at which
# the combine kernel reads vectors of 1, 2 and 4 features
@pytest.mark.parametrize("H,F", [(1, 20), (3, 16), (1, 4), (1, 3), (2, 3), (1, 6),
                                 (2, 6), (1, 36), (2, 36)])
def test_weighted_sum_and_vjp_match_jax(graphs, H, F):
    """Weights drawn at random per slot, so w[v,d] != w[u,rslot] (not
    symmetric): the reverse weights the backward reads through rslot are
    tested as they are."""
    jg, tg = graphs
    B, N, D = tg.nbr.shape
    values, weights = _normal(H * F, B, N, H, F), _normal(H + F, B, N, D, H)
    ct = _normal(7, B, N, H, F)
    out, g_v, g_w = _port_weighted_vjp(tg, values, weights, ct)
    m = tg.nbr_mask.numpy()[..., None]
    assert not (g_w * (1 - m)).any()                 # no gradient on padded slots

    want, vjp = jax.vjp(_jax_weighted_ref(jg, H, F), jnp.asarray(values),
                        jnp.asarray(weights))
    w_v, w_w = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_v, np.asarray(w_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_w, np.asarray(w_w) * m, rtol=1e-5, atol=1e-5)

    with jax_precision("exact"):
        want, vjp = jax.vjp(lambda v, w: tiled_weighted_sum(v, w, jg.tiled,
                                                            jg.nbr_mask),
                            jnp.asarray(values), jnp.asarray(weights))
        w_v, w_w = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(out, np.asarray(want), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(g_v, np.asarray(w_v), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(g_w, np.asarray(w_w) * m, rtol=5e-3, atol=5e-3)

    # the custom backward against autograd through the plain forward
    _, a_v, a_w = _port_weighted_vjp(
        tg, values, weights, ct,
        lambda v, w: weighted_sum.weighted_sum_plain(v, w, tg.nbr, tg.nbr_mask))
    np.testing.assert_allclose(g_v, a_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_w, a_w, rtol=1e-5, atol=1e-5)
    assert weighted_sum.weighted_sum.launches == 0
    assert weighted_sum.weighted_sum_reverse.launches == 0
    assert weighted_sum.pairdot.launches == 0


def test_weighted_sum_reverse_and_slot_gather_backward_are_transposes(graphs):
    """<weighted_sum(x, w), y> == <x, weighted_sum_reverse(y, w)> and
    <slot_gather(x), y> == <x, slot_gather_backward(y)>, to float32
    rounding (rtol 1e-5: the plain versions compute in float32)."""
    _, tg = graphs
    B, N, D = tg.nbr.shape
    args = (tg.nbr, tg.nbr_mask)
    x, y = (torch.from_numpy(_normal(s, B, N, 2, 5)) for s in (1, 2))
    w = torch.from_numpy(_normal(3, B, N, D, 2))
    lhs = (weighted_sum.weighted_sum_plain(x, w, *args) * y).sum()
    rhs = (x * weighted_sum.weighted_sum_reverse_plain(y, w, *args, tg.rslot)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0.0)
    x1 = torch.from_numpy(_normal(4, B, N, 3))
    y1 = torch.from_numpy(_normal(5, B, N, D, 3))
    lhs = (slot_gather.slot_gather_plain(x1, *args) * y1).sum()
    rhs = (x1 * slot_gather.slot_gather_backward_plain(y1, *args, tg.rslot)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0.0)


# (2,16) and (1,20), then the widths at which the pair-dot kernel reads
# vectors of 1 (F=3), 2 (F=6) and 4 (F=36, 16, 4) with 1, 2, 4, 8 or 16
# lanes a head, and one lane holding a whole head (F=4)
@pytest.mark.parametrize("H,F", [(2, 16), (1, 20), (1, 3), (2, 6), (1, 36), (4, 16),
                                 (1, 4)])
def test_sddmm_matches_jax(graphs, H, F):
    jg, tg = graphs
    B, N, D = tg.nbr.shape
    a, c = _normal(1 + H, B, N, H, F), _normal(2 + F, B, N, H, F)
    got = sddmm(torch.from_numpy(a), torch.from_numpy(c), tg.nbr, tg.nbr_mask)
    want = jax_sddmm(jnp.asarray(a), jnp.asarray(c), jg.nbr, jg.nbr_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = weighted_sum.pairdot_plain(torch.from_numpy(a), torch.from_numpy(c),
                                       tg.nbr, tg.nbr_mask)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with jax_precision("exact"):
        want = jax_sddmm(jnp.asarray(a), jnp.asarray(c), jg.nbr, jg.nbr_mask,
                         impl="pallas", tiled=jg.tiled)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3, atol=3e-3)


def _holed_mask(tg, frac=0.2, seed=11):
    """tg's mask with holes (punch_holes): tg.rslot still holds."""
    nbr, mask, rslot = (x.numpy() for x in (tg.nbr, tg.nbr_mask, tg.rslot))
    return punch_holes(np.random.default_rng(seed), nbr, mask, rslot, frac)


@pytest.mark.parametrize("H,F", [(1, 20), (4, 16), (2, 6)])
def test_pairdot_on_a_table_with_holes_matches_jax(graphs, H, F):
    """On a table with real slots after padded ones, sddmm and the pair
    dot's plain version against the JAX dense SDDMM (rtol/atol 1e-5), with
    exactly 0 on every padded slot (+0.0 from the pair dot)."""
    jg, tg = graphs
    B, N, D = tg.nbr.shape
    mask = _holed_mask(tg)
    a, c = _normal(30 + H, B, N, H, F), _normal(40 + F, B, N, H, F)
    want = np.asarray(jax_sddmm(jnp.asarray(a), jnp.asarray(c), jg.nbr,
                                jnp.asarray(mask)))
    args = (torch.from_numpy(a), torch.from_numpy(c), tg.nbr, torch.from_numpy(mask))
    for got in (sddmm(*args), weighted_sum.pairdot_plain(*args)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert (got.numpy()[mask == 0] == 0).all()
    plain = weighted_sum.pairdot_plain(*args).numpy()
    assert not np.signbit(plain[mask == 0]).any()
    assert (plain[mask > 0] != 0).all()              # the real slots do score
    assert weighted_sum.pairdot.launches == 0


@pytest.mark.parametrize("W", [1, 3, 4])
def test_slot_gather_backward_on_a_table_with_holes_matches_jax(graphs, W):
    """On the same holed table, the slot gather's backward (plain version,
    through gather_slots) against the VJP of the JAX dense gather times the
    mask (rtol/atol 1e-5), and bitwise equal to slot_gather_backward."""
    jg, tg = graphs
    B, N, D = tg.nbr.shape
    mask = _holed_mask(tg)
    x = _normal(50 + W, B, N, W)
    ct = _normal(60 + W, B, N, D, W)
    t = torch.from_numpy(x).requires_grad_()
    out = slot_gather.gather_slots(t, tg.nbr, torch.from_numpy(mask), tg.rslot)
    out.backward(torch.from_numpy(ct))

    def dense(v):
        return _dense_gather(v, jg.nbr) * jnp.asarray(mask)[..., None]

    want, vjp = jax.vjp(dense, jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-5, atol=1e-5)
    direct = slot_gather.slot_gather_backward(torch.from_numpy(ct), tg.nbr,
                                              torch.from_numpy(mask), tg.rslot)
    assert torch.equal(direct, t.grad)
    assert slot_gather.slot_gather_backward.launches == 0


@pytest.mark.parametrize("case", ["pairdot N*H*F", "pairdot N*D*H", "slot_gather_bwd"])
def test_kernels_refuse_offsets_past_32_bits(case, monkeypatch):
    """The pair dot indexes a graph, and the slot gather's backward its
    gout, with 32-bit integers: past 2**31 the wrappers raise ValueError
    before they build anything (meta tensors: no memory, no card)."""
    def no_build():
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(weighted_sum, "build", no_build)
    monkeypatch.setattr(slot_gather, "build", no_build)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    if case == "slot_gather_bwd":
        n = 2 ** 23
        nbr = meta(1, n, 16, dtype=torch.int32)
        with pytest.raises(ValueError, match=r"B\*N\*D\*W = 2147483648 >= 2\*\*31"):
            slot_gather.slot_gather_backward(meta(1, n, 16, 16), nbr, meta(1, n, 16),
                                             torch.empty_like(nbr))
        return
    n, D, H, F = (2 ** 23, 12, 1, 256) if case == "pairdot N*H*F" else (2 ** 24, 128, 1, 4)
    what = case.split()[1].replace("*", r"\*")
    a = meta(1, n, H, F)
    with pytest.raises(ValueError, match=rf"{what} = 2147483648 >= 2\*\*31"):
        weighted_sum.pairdot(a, torch.empty_like(a), meta(1, n, D, dtype=torch.int32),
                             meta(1, n, D))


def _grads_within(grads, want, rel):
    want = jax.tree_util.tree_leaves(want)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("model_type,agg", [("GSmean", "mean"), ("GSgcn", "gcn")])
def test_weighted_sage_matches_jax(graphs, model_type, agg):
    jg, tg = graphs
    jmodel = JaxGraphSage(20, [16, 16], 4, agg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = gnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))

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
    _grads_within(grads, want_grads, 1e-5)
    # the weights change the result: unweighted logits differ
    with precision_scope("exact"), torch.no_grad():
        plain = model(tg.replace(edge_weight=None))
    assert not torch.allclose(plain, logits)


def _jax_attention_masks(jmodel, key, shape_bnd, keep):
    """The keep-masks JAX's GAT.apply draws for its attention dropout
    (models/gat.py:217, 80, 131): per layer rng_i = split(key, n)[i], then
    bernoulli(split(rng_i, 2)[1], keep, alpha.shape)."""
    B, N, D = shape_bnd
    layer_keys = jax.random.split(key, jmodel.num_layers)
    return [np.array(jax.random.bernoulli(jax.random.split(k, 2)[1], keep,
                                            (B, N, D, heads)))
            for k, (_, _, heads, _) in zip(layer_keys, jmodel.specs)]


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_gat_attention_dropout_matches_jax(graphs, impl, monkeypatch):
    jg, tg = graphs
    rate = 0.3
    heads, residuals, widths = [3, 2], [False, True], [8, 8]
    jmodel = JaxGAT(20, widths, 4, heads=heads, residuals=residuals,
                    attn_drop=rate)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                residuals)
    model.attn_drop = rate
    key = jax.random.PRNGKey(9)
    masks = _jax_attention_masks(jmodel, key, tuple(tg.nbr.shape), 1.0 - rate)
    assert 0.6 < np.mean(np.concatenate([m.ravel() for m in masks])) < 0.8

    def jax_loss(p):
        logits = jmodel.apply(p, jg, train=True, rng=key, impl=impl)
        return jax_wce(logits, jg.labels, jnp.asarray(CLASS_WEIGHTS),
                       jg.node_mask), logits

    with jax_precision("exact"):
        (_, want_logits), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(
            jparams)

    drawn = iter(masks)

    def shared_dropout(x, rate, generator):
        """The port's dropout with JAX's keep-mask in place of its own draw
        (only attention dropout is on in this model)."""
        if rate <= 0.0:
            return x
        keep = torch.from_numpy(next(drawn))
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(gat_module, "_dropout", shared_dropout)
    with precision_scope("exact"):
        logits = model(tg, train=True)
        loss = weighted_cross_entropy(logits, tg.labels,
                                      torch.from_numpy(CLASS_WEIGHTS), tg.node_mask)
        grads = torch.autograd.grad(loss, model.jax_parameters())
    assert next(drawn, None) is None                 # one mask per layer
    tol = {"dense": (1e-5, 1e-4), "pallas": (5e-3, 2e-2)}[impl]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=tol[0], atol=tol[0])
    _grads_within(grads, want_grads, tol[1])
    # the masks matter: without dropout the logits differ
    with precision_scope("exact"), torch.no_grad():
        assert not torch.allclose(model(tg), logits)


def test_weighted_gradients_need_rslot(graphs):
    _, tg = graphs
    B, N, D = tg.nbr.shape
    h = torch.zeros(B, N, 5, requires_grad=True)
    for op in ("sum", "mean"):
        with pytest.raises(ValueError, match="reciprocal slots"):
            aggregate_neighbors(h, tg.nbr, tg.nbr_mask, op,
                                edge_weight=tg.edge_weight)
        with torch.no_grad():                        # inference needs none
            aggregate_neighbors(h, tg.nbr, tg.nbr_mask, op,
                                edge_weight=tg.edge_weight)
    with pytest.raises(ValueError, match="reciprocal slots"):
        slot_gather.gather_slots(torch.zeros(B, N, 2, requires_grad=True),
                                 tg.nbr, tg.nbr_mask)
    with pytest.raises(ValueError, match="reciprocal slots"):
        weighted_sum.weighted_combine(torch.zeros(B, N, 1, 4),
                                      torch.ones(B, N, D, 1, requires_grad=True),
                                      tg.nbr, tg.nbr_mask)
