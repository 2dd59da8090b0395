"""The roofline arithmetic reproduces the byte bounds PERF.md's kernel
table quotes (chip_smoke.py's timing phases: B=6, N=8192, D=12, 7000 real
nodes a graph, every one referenced and live), and the FLOP counts follow
the layer widths."""

import pytest

from benchmark import flops
from benchmark.roofline import gat_attn, max_agg
from benchmark.weights import gat_layers

B, N, D, REF = 6, 8192, 12, 6 * 7000


def ms(nbytes):
    return max_agg.bound_s(nbytes) * 1e3


@pytest.mark.parametrize("F,es,kernel,want", [
    (256, 4, "fwd", 0.03303), (20, 4, "fwd", 0.00388),
    (256, 2, "fwd", 0.01910), (20, 2, "fwd", 0.00279),
    (256, 4, "bwd", 0.03318), (20, 4, "bwd", 0.00454),
    (256, 2, "bwd", 0.01925), (20, 2, "bwd", 0.00345),
])
def test_max_agg_bounds(F, es, kernel, want):
    fn = max_agg.forward_bytes if kernel == "fwd" else max_agg.backward_bytes
    assert round(ms(fn(B, N, D, F, es, REF)), 5) == want


@pytest.mark.parametrize("H,F,es,residual,want", [
    (4, 256, 4, False, 0.11685), (3, 256, 4, False, 0.08799),
    (3, 256, 4, True, 0.13306), (1, 4, 4, False, 0.00284),
    (4, 256, 2, False, 0.06089), (3, 256, 2, True, 0.06856),
])
def test_gat_fwd_bounds(H, F, es, residual, want):
    nbytes = gat_attn.forward_bytes(B, N, D, H, F, es, REF, residual=residual)
    assert round(gat_attn.bound_s(nbytes) * 1e3, 5) == want


@pytest.mark.parametrize("H,F,es,bwd,rev", [
    (4, 256, 4, 0.11069, 0.11943), (3, 256, 4, 0.08337, 0.09010),
    (1, 4, 4, 0.00345, 0.00402), (4, 256, 2, 0.05933, 0.06371),
])
def test_gat_bwd_rev_bounds(H, F, es, bwd, rev):
    b = gat_attn.backward_bytes(B, N, D, H, F, es, REF, REF)
    r = gat_attn.reverse_bytes(B, N, D, H, F, es, REF)
    assert round(gat_attn.bound_s(b) * 1e3, 5) == bwd
    assert round(gat_attn.bound_s(r) * 1e3, 5) == rev


def test_step_bounds_sum_the_layers():
    shapes = {"B": B, "N": N, "D": D, "es": 4, "referenced": REF, "live": REF}
    widths = [20] + [256] * 6
    want = sum(max_agg.bound_s(max_agg.forward_bytes(B, N, D, F, 4, REF))
               + max_agg.bound_s(max_agg.backward_bytes(B, N, D, F, 4, REF))
               for F in widths)
    assert max_agg.step_bound_s(shapes, widths) == pytest.approx(want)
    layers = gat_layers(20, [256] * 4, [4, 4, 3, 3], [False, False, True, False], 4)
    assert [l[2] for l in layers] == [4, 4, 3, 3, 1]
    assert gat_attn.step_bound_s(shapes, layers) > 0


def test_flops_follow_the_widths():
    # one SAGE-pool layer 256 -> 256 over 10 nodes and 30 edges: the pool
    # product, two output products, one compare per edge and feature
    assert flops.sage_pool_layer(10, 30, 256, 256) == (
        2 * 10 * 256 * 256 + 4 * 10 * 256 * 256 + 30 * 256)
    cfg = {"model": "GSpool", "in_feats": 20, "layer_sizes": [256] * 6, "out_classes": 4}
    per = flops.gnn_layers(cfg, 100, 1000)
    assert len(per) == 7
    assert flops.gnn_train_step(cfg, 100, 1000) == pytest.approx(
        2 * per[0] + 3 * sum(per[1:]))
    cnn = {"in_feats": 8, "layer_sizes": [16], "out_classes": 4, "kernel": 5}
    assert flops.cnn_forward(cnn, 1) == 2 * 125 * (8 * 16 + 16 * 4)
