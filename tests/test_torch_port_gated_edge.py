"""GraphGPS's GatedGCN edge block (ops/kernels/gated_edge.py).

On the CPU: the plain version against the composition models/gps.py ran
before the kernels (`_composition`, its lines as they were), forward and
every gradient, bitwise; a GPS forward and backward with the block's call
site against the layer with that composition in its place, bitwise, and
under dropout against the layer's former forward (`_former_forward`: the
same masks from the same generator); the step counters; the wrappers'
refusals and dispatch.

On the card (marked `card`; the `card` fixture skips without a CUDA
device): the kernels against the float32 plain version on the same inputs,
at small shapes and at the train-gps-b6 cell's, with and without an edge
dropout mask, and two launches of forward and backward bitwise equal. The file imports no JAX, so it runs on the card
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_port_gated_edge.py

Inputs are as the model feeds the block: the upstream gradient of e' is 0
on padded slots (the next layer's masked ê gives them none), and b_j and
e_j are 0 there (the slot gather's zeros). Tolerances of the kernels,
relative to the largest value of the float32 plain version: float32 1e-4
(sums over slots and over the batch's slots in another order; the
BatchNorm's backward subtracts its mean terms). bfloat16 2e-2 forward and
5e-2 backward (ê, y and every output rounded to 8 bits, 4e-3 a rounding,
before the sums and the BatchNorm's cancellations), on inputs whose real
slots keep the BatchNorm's output y at least 0.05 from the ReLU's kink
(`_clear_of_the_kink`): a slot within a rounding of it takes the other side
in bfloat16 than in float32, in the plain bfloat16 version as in the
kernels though not always at the same slots, and moves its channel's
gradients by a whole upstream value (up to 0.9 of the largest dê seen). chip_smoke.py `phase_gated_edge_check`
moves its inputs the same way (`gated_edge_clear_of_the_kink`) and holds
them to the same limits.
"""

import math

import pytest
import torch

from gnn_tumor_seg_tpu_torch.config import HyperParams
from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
from gnn_tumor_seg_tpu_torch.models import gps
from gnn_tumor_seg_tpu_torch.models.gps import GPSLayer, MaskedBatchNorm
from gnn_tumor_seg_tpu_torch.models.sage import _dropout
from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, masked_copy
from gnn_tumor_seg_tpu_torch.ops.kernels import gated_edge as ge
from gnn_tumor_seg_tpu_torch.ops.kernels import launch_counts
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer

W = 8
GRADS = ("e", "w_c", "e_j", "b_j", "d", "a", "g", "b")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _composition(e, w_c, e_j, b_j, d, a, emask, pad_slots, bn, count, train,
                 dropout=None):
    """The block as models/gps.py computed it before ops/kernels/gated_edge.py
    (its lines, with the layer's names made arguments; `dropout` a function
    of the edge update's ReLU output, its _dropout call)."""
    cd = e.dtype
    e_hat = ((e @ w_c).add_(e_j).add_(d[:, :, None, :])
             .mul_(emask[..., None].to(cd)))
    sigma = torch.sigmoid(e_hat)
    den = sigma.sum(2, dtype=torch.float32) - 0.5 * pad_slots
    num = (sigma * b_j).sum(2, dtype=torch.float32)
    x = a + (num / (den + 1e-6)).to(cd)
    if bn is None:
        return x, None
    e_new = torch.relu(bn(e_hat, None, count, train))
    return x, e + (e_new if dropout is None else dropout(e_new))


def _former_forward(self, graph, h, e, counts, train, dropout=0.0, generator=None):
    """GPSLayer.forward as it was before ops/kernels/gated_edge.py (its lines,
    the spans and comments left out)."""
    cd = h.dtype
    W = self.width
    nmask, emask = graph.node_mask, graph.nbr_mask
    n_nodes, n_edges, pad_slots, n_real = counts
    drop = dropout if train else 0.0

    def p(name):
        return getattr(self, name).to(cd)

    adbe = h @ p("w_adbe")
    a = adbe[..., :W] + p("b_a")
    d = adbe[..., W:2 * W] + (p("b_d") + p("b_c"))
    b_j, e_j = (gps.slot_gather.gather_slots(adbe[..., k * W:(k + 1) * W]
                                             + p(f"b_{c}"), graph.nbr, emask,
                                             graph.rslot)
                for k, c in ((2, "b"), (3, "e")))
    e_hat = ((e @ p("w_c")).add_(e_j).add_(d[:, :, None, :])
             .mul_(emask[..., None].to(cd)))
    sigma = torch.sigmoid(e_hat)
    den = sigma.sum(2, dtype=torch.float32) - 0.5 * pad_slots
    num = (sigma * b_j).sum(2, dtype=torch.float32)
    x = a + (num / (den + 1e-6)).to(cd)
    x = torch.relu(self.bn_x(x, nmask, n_nodes, train))
    h_local = h + _dropout(x, drop, generator)
    if self.edge_out:
        e_new = torch.relu(self.bn_e(e_hat, None, n_edges, train))
        e = e + _dropout(e_new, drop, generator)
    else:
        e = None
    h_local = self.bn_local(h_local, nmask, n_nodes, train)
    b_qkv = torch.cat([p("b_q"), p("b_k"), p("b_v")])
    qkv = h @ p("w_qkv") + b_qkv
    att = (gps.graph_attention(qkv, self.heads, nmask, n_real) @ p("w_o")
           + p("b_o"))
    h_attn = self.bn_attn(h + _dropout(att, drop, generator), nmask, n_nodes, train)
    s = h_local + h_attn
    f = _dropout(torch.relu(s @ p("w_ff1") + p("b_ff1")), drop, generator)
    f = _dropout(f @ p("w_ff2") + p("b_ff2"), drop, generator)
    h = self.bn_ff(s + f, nmask, n_nodes, train)
    return h, e


def _inputs(B, N, D, width, dtype, seed, device="cpu", real=None, slot_p=0.6):
    """The block's inputs, float32 drawn on the CPU and cast: graphs of
    `real` real rows (default N, 2N/3 and, last, none), real slots drawn
    with probability slot_p on real rows; e, e_j, b_j and the upstream
    gradients as the model gives them (module doc); a seeded BatchNorm."""
    gen = torch.Generator().manual_seed(seed)
    real = real or [N, 2 * N // 3, 0][:B] + [N] * max(0, B - 3)
    rows = (torch.arange(N)[None] < torch.tensor(real)[:, None]).float()
    emask = (torch.rand((B, N, D), generator=gen) < slot_p).float() * rows[..., None]
    m = emask[..., None]
    t = {"e": torch.randn((B, N, D, width), generator=gen),
         "w_c": torch.randn((width, width), generator=gen) / math.sqrt(width),
         "e_j": torch.randn((B, N, D, width), generator=gen) * m,
         "b_j": torch.randn((B, N, D, width), generator=gen) * m,
         "d": torch.randn((B, N, width), generator=gen),
         "a": torch.randn((B, N, width), generator=gen),
         "dx": torch.randn((B, N, width), generator=gen),
         "de": torch.randn((B, N, D, width), generator=gen) * m}
    t = {k: v.to(device=device, dtype=dtype) for k, v in t.items()}
    bn = MaskedBatchNorm(width)
    with torch.no_grad():
        bn.g.uniform_(-0.5, 0.5, generator=gen)
        bn.b.uniform_(-0.2, 0.2, generator=gen)
        bn.running_mean.uniform_(-0.5, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
    emask = emask.to(device)
    pad = emask.shape[-1] - emask.sum(-1, keepdim=True)
    return t, emask, pad, emask.sum(), bn.to(device)


def _clear_of_the_kink(t, emask, count, bn, train, margin=0.05):
    """Move e_j on the real slots whose float32 BatchNorm output y = a ê + c
    lies within `margin` of 0 by 2 margin / |a| away from it, until none
    does (module doc)."""
    real = emask[..., None] > 0
    for _ in range(5):
        e_hat = ((t["e"].float() @ t["w_c"].float() + t["e_j"].float()
                  + t["d"].float()[:, :, None]) * real)
        if train:
            mean = e_hat.sum((0, 1, 2)) / count
            var = (e_hat.square().sum((0, 1, 2)) / count - mean * mean).clamp_min(0)
        else:
            mean, var = bn.running_mean, bn.running_var
        a = torch.rsqrt(var + bn.eps) * (1 + bn.g.detach())
        y = e_hat * a + (bn.b.detach() - mean * a)
        near = (y.abs() < margin) & real
        if not near.any():
            return
        away = torch.where(y < 0, -1.0, 1.0) * 2 * margin / a.abs()
        t["e_j"] = torch.where(near, t["e_j"].float() + away, t["e_j"].float()
                               ).to(t["e_j"].dtype)
    raise AssertionError("inputs still near the ReLU's kink")


def _run(block, t, emask, pad, count, bn, train, edge_out=True, dtype=None,
         drop=None):
    """Forward and backward of `block` on copies of the inputs (cast to
    `dtype` if given) and of the BatchNorm, with the edge update's `drop`
    (keep, rate) if given: (x, e', running statistics, gradients by
    name)."""
    dtype = dtype or t["e"].dtype
    leaves = {k: t[k].to(dtype).detach().clone().requires_grad_(True)
              for k in GRADS[:6]}
    norm = None
    if edge_out:
        norm = MaskedBatchNorm(bn.g.shape[0]).to(bn.g.device)
        norm.load_state_dict(bn.state_dict())
    x, e_new = block(leaves["e"], leaves["w_c"], leaves["e_j"], leaves["b_j"],
                     leaves["d"], leaves["a"], emask, pad, norm, count, train, drop)
    loss = (x.float() * t["dx"].float()).sum()
    if edge_out:
        loss = loss + (e_new.float() * t["de"].float()).sum()
    loss.backward()
    grads = {k: v.grad for k, v in leaves.items()}
    stats = ()
    if edge_out:
        grads.update(g=norm.g.grad, b=norm.b.grad)
        stats = (norm.running_mean, norm.running_var)
    return x, e_new, stats, grads


# ------------------------------------------------------------------- CPU


@pytest.mark.parametrize("D", [3, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("edge_out", [True, False], ids=["edge_out", "last"])
def test_plain_is_the_former_composition(D, dtype, train, edge_out):
    """Forward, running statistics and the gradients of e, w_c (so eW's),
    e_j, b_j, d, a and BN_e's g and b bitwise those of `_composition`, with
    padded rows and slots and a graph with no real node."""
    t, emask, pad, count, bn = _inputs(3, 10, D, W, dtype, seed=D)
    got = _run(ge.gated_edge_plain, t, emask, pad, count, bn, train, edge_out)
    want = _run(_composition, t, emask, pad, count, bn, train, edge_out)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (not edge_out)
    if edge_out:
        assert torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    assert all(torch.isfinite(g).all() for g in got[3].values())


def _gps_batch(n_graphs=3):
    data = SyntheticGraphDataset(n_samples=n_graphs, grid=4, seed=11)
    graphs = [data.get_graph(i) for i in range(n_graphs)]
    return batch_graphs(graphs + [masked_copy(graphs[0])])


def _gps_step(model, batch, mode, seed=None):
    model.zero_grad()
    gen = None
    if seed is not None:
        gen = torch.Generator(device=batch.node_mask.device).manual_seed(seed)
    with precision_scope(mode):
        out = model(batch, train=True, generator=gen)
    (out * torch.linspace(-1, 1, out.shape[-1], device=out.device)).sum().backward()
    return out, [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_gps_step_matches_the_former_layer(mode, monkeypatch):
    """A GPS forward and backward (2 layers of 16, 2 heads; 3 graphs and a
    masked copy with no real node) gives bitwise the logits, gradients and
    running statistics of the layer with `_composition` at the block's call
    site, as models/gps.py ran before."""
    hp = HyperParams(in_feats=20, layer_sizes=[16, 16], gps_heads=2,
                     gps_post_layers=3, out_classes=4)
    model = init_graph_net("GPS", hp)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _gps_batch()
    out, grads = _gps_step(model, batch, mode)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    monkeypatch.setattr(ge, "gated_edge", _composition)
    want_out, want_grads = _gps_step(model, batch, mode)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_gps_dropout_step_matches_the_former_layer(mode, monkeypatch):
    """With feature dropout 0.25 and a seeded generator, a GPS forward and
    backward gives bitwise the logits, gradients and running statistics of
    the layer's former forward: the node's mask of x and then the edge
    update's are drawn in the order the former layer drew them."""
    hp = HyperParams(in_feats=20, layer_sizes=[16, 16, 16], gps_heads=2,
                     gps_post_layers=3, out_classes=4, feature_dropout=0.25)
    model = init_graph_net("GPS", hp)
    assert model.dropout == 0.25
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _gps_batch()
    out, grads = _gps_step(model, batch, mode, seed=3)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    monkeypatch.setattr(GPSLayer, "forward", _former_forward)
    want_out, want_grads = _gps_step(model, batch, mode, seed=3)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items())
    # the masks did drop something: another seed gives other logits
    model.load_state_dict(state)
    assert not torch.equal(_gps_step(model, batch, mode, seed=4)[0], want_out)


def test_counters_count_the_edge_blocks_on_the_cpu():
    """gated_edge_layers counts every layer's block a step; on the CPU none
    takes the kernels."""
    hp = HyperParams(in_feats=20, layer_sizes=[8, 8, 8], gps_heads=2,
                     gps_post_layers=3, out_classes=4, batch_size=2)
    data = SyntheticGraphDataset(n_samples=3, grid=4, seed=5)
    trainer = GNNTrainer("GPS", hp, data, seed=0, precision="fast", device="cpu")
    trainer.run_epoch()
    stats = trainer.last_epoch_stats
    assert stats["steps"] == 2
    assert stats["gated_edge_layers"] == 3 * 2
    assert stats["gated_edge_fused"] == 0


def test_dropout_and_the_cpu_take_the_plain_version(monkeypatch):
    """On the CPU `gated_edge` is the plain version, with and without an
    edge dropout mask: no kernel is built or launched, and with the mask e'
    is e + keep ⊙ ReLU(BN_e(ê)) / (1 - rate), as the former dropout gave
    it."""
    def no_build():
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(ge, "_LIB", None)
    monkeypatch.setattr(ge, "build", no_build)
    t, emask, pad, count, bn = _inputs(2, 6, 4, W, torch.float32, seed=1)
    keep = torch.rand(t["e"].shape, generator=torch.Generator().manual_seed(2)) < 0.7
    before = launch_counts()
    outs = []
    for drop, dropout in ((None, None),
                          ((keep, 0.3), lambda v: torch.where(keep, v / 0.7,
                                                              torch.zeros(())))):
        norms = [MaskedBatchNorm(W) for _ in range(2)]
        for norm in norms:
            norm.load_state_dict(bn.state_dict())
        got = ge.gated_edge(t["e"], t["w_c"], t["e_j"], t["b_j"], t["d"], t["a"],
                            emask, pad, norms[0], count, True, drop)
        want = _composition(t["e"], t["w_c"], t["e_j"], t["b_j"], t["d"], t["a"],
                            emask, pad, norms[1], count, True, dropout)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        outs.append(got[1])
    assert not torch.equal(*outs)
    assert launch_counts() == before


def _meta(B=2, N=6, D=4, width=W, dtype=torch.bfloat16):
    meta = dict(device="meta", dtype=dtype)
    edge = torch.empty((B, N, D, width), **meta)
    node = torch.empty((B, N, width), **meta)
    emask = torch.empty((B, N, D), device="meta")
    return edge, node, emask


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_wrappers_raise_without_the_library(which, monkeypatch):
    """Off the CPU the wrappers build and launch the kernels or raise: with
    no library they raise, and never take the plain version (meta tensors:
    no memory, no card)."""
    def no_toolkit():
        raise RuntimeError("no CUDA toolkit found")

    monkeypatch.setattr(ge, "_LIB", None)
    monkeypatch.setattr(ge, "build", no_toolkit)
    edge, node, emask = _meta()
    f32 = torch.empty((2, 6, W), device="meta")
    before = launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        if which == "forward":
            ge.gated_edge_forward(edge, edge, edge, node, node, emask)
        else:
            ge.gated_edge_backward(node, None, edge, edge, emask, f32, f32, None,
                                   None, None, True)
    assert launch_counts() == before


@pytest.mark.parametrize("shape,dtype,what", [
    ((2, 6, 4, 400), torch.bfloat16, "widths up to 384"),
    ((2, 6, 4, W), torch.float16, "float32 or bfloat16"),
    ((64, 8192, 64, 96), torch.bfloat16, r"B\*N\*D\*W = 3221225472 >= 2\*\*31"),
    ((2, 6, 4, W), torch.bfloat16, "drop needs bn"),
    ((2, 6, 4, W), torch.bfloat16, "keep must be torch.bool"),
    ((2, 6, 4, W), torch.bfloat16, r"rate must lie in \(0, 1\)"),
], ids=["W=400", "float16", "past 32 bits", "drop without bn", "keep not bool",
        "rate 1"])
def test_wrappers_refuse_what_the_kernels_do_not_take(shape, dtype, what, monkeypatch):
    """Widths past 384, types other than float32 and bfloat16, offsets past
    32 bits, and a dropout mask without an edge update, of another type than
    bool or at a rate outside (0, 1) raise ValueError before anything is
    built."""
    def no_build():
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(ge, "_LIB", None)
    monkeypatch.setattr(ge, "build", no_build)
    B, N, D, width = shape
    edge, node, emask = _meta(B, N, D, width, dtype)
    keep = torch.empty(edge.shape, device="meta", dtype=torch.bool)
    bn = MaskedBatchNorm(width).to("meta")
    count = torch.empty((), device="meta")
    extra = {"drop needs bn": dict(drop=(keep, 0.5)),
             "keep must be": dict(e=edge, bn=bn, count=count,
                                  drop=(keep.to(edge.dtype), 0.5)),
             "rate must lie": dict(e=edge, bn=bn, count=count, drop=(keep, 1.0))}
    kwargs = next((v for k, v in extra.items() if what.startswith(k)), {})
    with pytest.raises(ValueError, match=what):
        ge.gated_edge_forward(edge, edge, edge, node, node, emask, **kwargs)


def test_launch_counts_list_the_gated_edge_wrappers():
    counts = launch_counts()
    assert counts["gated_edge"] == ge.gated_edge_forward.launches
    assert counts["gated_edge_bwd"] == ge.gated_edge_backward.launches


# ------------------------------------------------------------------ card


def _gap(got, want, mask=None, scale=0.0) -> float:
    """Largest |got - want| over the largest |want| or `scale` if larger (on
    mask's slots)."""
    got, want = got.detach().float(), want.detach().float()
    if mask is not None:
        keep = mask[..., None].expand_as(want) > 0
        got, want = got[keep], want[keep]
    top = max(float(want.abs().max()) if want.numel() else 0.0, scale)
    return float((got - want).abs().max()) / top if top else 0.0


def _gaps(got, want, emask) -> dict:
    """Each output's gap (_gap) of a _run to a reference _run."""
    gaps = {"x": _gap(got[0], want[0])}
    if got[1] is not None:
        gaps["e_new"] = _gap(got[1], want[1], emask)
        for name, a, b in zip(("running_mean", "running_var"), got[2], want[2]):
            gaps[name] = _gap(a, b)
    for k in got[3]:
        gaps["d" + k] = _gap(got[3][k], want[3][k], emask if k == "b_j" else None)
    return gaps


FORWARD = ("x", "e_new", "running_mean", "running_var")


def _compare(t, emask, pad, count, bn, train, edge_out, drop=None):
    """Kernels against the float32 plain version on the same inputs (module
    doc), with the edge dropout `drop` if given: the gaps by output."""
    if edge_out:
        _clear_of_the_kink(t, emask, count, bn, train)
    got = _run(ge.gated_edge, t, emask, pad, count, bn, train, edge_out, drop=drop)
    want = _run(ge.gated_edge_plain, t, emask, pad, count, bn, train, edge_out,
                dtype=torch.float32, drop=drop)
    if edge_out:
        bits = torch.int16 if got[1].dtype == torch.bfloat16 else torch.int32
        assert not got[1][emask == 0].view(bits).any()
    gaps = _gaps(got, want, emask)
    f32 = t["e"].dtype == torch.float32
    for k, v in gaps.items():
        limit = 1e-4 if f32 else (2e-2 if k in FORWARD else 5e-2)
        assert v <= limit, (k, v, limit, gaps)
    return gaps


@pytest.mark.card
@pytest.mark.parametrize("width", [8, 12, 6, 96])
@pytest.mark.parametrize("D", [3, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("edge_out", [True, False], ids=["edge_out", "last"])
def test_kernels_match_plain_on_the_card(card, width, D, dtype, train, edge_out):
    """Small shapes (3 graphs of 40 rows, one with no real node; W = 6 takes
    the one-channel runs in bfloat16) against the float32 plain version."""
    t, emask, pad, count, bn = _inputs(3, 40, D, width, dtype, seed=width + D,
                                       device=card)
    gaps = _compare(t, emask, pad, count, bn, train, edge_out)
    print(f"[gated_edge] W={width} D={D} {dtype} train={train} "
          f"edge_out={edge_out}: {gaps}")


@pytest.mark.card
@pytest.mark.parametrize("width", [8, 6, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_with_dropout_match_plain_on_the_card(card, width, dtype):
    """An edge dropout mask at rate 0.3 (training, D = 24): the kernels
    against the float32 plain version with the same mask, e' and every
    gradient; a dropped slot's e' is e."""
    t, emask, pad, count, bn = _inputs(3, 40, 24, width, dtype, seed=width + 1,
                                       device=card)
    gen = torch.Generator(device=card).manual_seed(width)
    keep = torch.rand(t["e"].shape, generator=gen, device=card) < 0.7
    gaps = _compare(t, emask, pad, count, bn, True, True, drop=(keep, 0.3))
    got = _run(ge.gated_edge, t, emask, pad, count, bn, True, drop=(keep, 0.3))
    dropped = ~keep & (emask[..., None] > 0)
    assert torch.equal(got[1][dropped], t["e"][dropped])
    print(f"[gated_edge] dropout W={width} {dtype}: {gaps}")


@pytest.mark.card
def test_kernels_match_plain_at_the_cell_shape(card):
    """The train-gps-b6 cell's shape: 6 graphs of 7 000 real rows padded to
    8 192, 24 slots of which ~half real, W = 96, bfloat16, training."""
    t, emask, pad, count, bn = _inputs(6, 8192, 24, 96, torch.bfloat16, seed=7,
                                       device=card, real=[7000] * 6, slot_p=0.55)
    gaps = _compare(t, emask, pad, count, bn, True, True)
    print(f"[gated_edge] cell shape: {gaps}")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_two_launches_are_bitwise_equal(card, dtype):
    """Forward and backward twice on the same inputs and BatchNorm state:
    outputs, running statistics and every gradient bitwise equal (no
    atomics); the launches counted, 3 + 3 a block with an edge update."""
    t, emask, pad, count, bn = _inputs(6, 1024, 24, 96, dtype, seed=3, device=card,
                                       real=[1000, 900, 0, 1024, 512, 7])
    before = launch_counts()
    first = _run(ge.gated_edge, t, emask, pad, count, bn, True)
    after = launch_counts()
    second = _run(ge.gated_edge, t, emask, pad, count, bn, True)
    assert after["gated_edge"] - before["gated_edge"] == 3
    assert after["gated_edge_bwd"] - before["gated_edge_bwd"] == 3
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert all(torch.equal(a, b) for a, b in zip(first[2], second[2]))
    for k in first[3]:
        a, b = first[3][k], second[3][k]
        if k == "b_j":      # padded slots unwritten
            a, b = a[emask > 0], b[emask > 0]
        assert torch.equal(a, b), k


@pytest.mark.card
def test_gps_dropout_on_the_card_matches_plain(card, monkeypatch):
    """A GPS exact step with feature dropout 0.25 and a seeded generator:
    every layer's block launches the kernels, and the logits and gradients
    are within 1e-4 of those through the plain version with the same
    generator (each leaf's gap as in the test below)."""
    hp = HyperParams(in_feats=20, layer_sizes=[16, 16, 16], gps_heads=2,
                     gps_post_layers=3, out_classes=4, feature_dropout=0.25)
    model = init_graph_net("GPS", hp).to(card)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _gps_batch().to(card)
    before = ge.gated_edge_forward.launches
    out, grads = _gps_step(model, batch, "exact", seed=3)
    assert ge.gated_edge_forward.launches - before == 3 + 3 + 1
    assert all(layer.gated_edge_fused for layer in model.layers)
    model.load_state_dict(state)
    monkeypatch.setattr(ge, "gated_edge", ge.gated_edge_plain)
    want_out, want_grads = _gps_step(model, batch, "exact", seed=3)
    assert _gap(out, want_out) <= 1e-4
    median = sorted(float(g.abs().max()) for g in want_grads)[len(want_grads) // 2]
    assert max(_gap(a, b, scale=median) for a, b in zip(grads, want_grads)) <= 1e-4


@pytest.mark.card
def test_gps_on_the_card_counts_and_matches_plain(card, monkeypatch):
    """A GPS epoch on the card: every layer's block takes the kernels
    (gated_edge_fused == gated_edge_layers), and an exact step's logits and
    gradients through the kernels are within 1e-4 of those through the
    plain version, each leaf's gap over its largest value or the median
    leaf's, where larger (a bias that a BatchNorm subtracts again has a
    gradient of rounding alone)."""
    hp = HyperParams(in_feats=20, layer_sizes=[16, 16, 16], gps_heads=2,
                     gps_post_layers=3, out_classes=4, batch_size=2)
    data = SyntheticGraphDataset(n_samples=3, grid=4, seed=5)
    trainer = GNNTrainer("GPS", hp, data, seed=0, precision="fast", device="cuda")
    trainer.run_epoch()
    stats = trainer.last_epoch_stats
    assert stats["gated_edge_layers"] == stats["gated_edge_fused"] == 3 * 2

    model = init_graph_net("GPS", hp).to(card)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _gps_batch().to(card)
    out, grads = _gps_step(model, batch, "exact")
    model.load_state_dict(state)
    monkeypatch.setattr(ge, "gated_edge", ge.gated_edge_plain)
    want_out, want_grads = _gps_step(model, batch, "exact")
    assert _gap(out, want_out) <= 1e-4
    median = sorted(float(g.abs().max()) for g in want_grads)[len(want_grads) // 2]
    assert max(_gap(a, b, scale=median) for a, b in zip(grads, want_grads)) <= 1e-4
