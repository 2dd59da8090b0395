"""GraphGPS's varlen attention (ops/kernels/graph_attn.py) on the CPU: the
plain versions of the forward and the backward against the SDPA path of
models/gps.py and against a per-graph einsum softmax, the zeros on padded
rows and empty graphs, the autograd Function, and the CUDA wrappers'
refusals. The kernels themselves are held to the plain versions on the
card (chip_smoke.py `phase_graph_attn_check`).

Tolerances (float32): 1e-5 of the largest value for the forward and 1e-4
for d(qkv) (sums over at most 70 keys in another order; the backward
subtracts rowsum(dO * O) from each dP)."""

import math

import pytest
import torch

from gnn_tumor_seg_tpu_torch.models.gps import _sdpa_attention
from gnn_tumor_seg_tpu_torch.ops.kernels import graph_attn, launch_counts

H, F, N = 3, 12, 70


def _inputs(counts, seed=0, garbage=0.0):
    """qkv [B, N, 3*H*F] and gout [B, N, H*F], normal; padded rows hold
    `garbage` times larger values (they must move nothing)."""
    gen = torch.Generator().manual_seed(seed)
    B = len(counts)
    qkv = torch.randn((B, N, 3 * H * F), generator=gen)
    gout = torch.randn((B, N, H * F), generator=gen)
    for b, n in enumerate(counts):
        qkv[b, n:] *= garbage
        gout[b, n:] *= garbage
    return qkv, gout, torch.tensor(counts, dtype=torch.int32)


def _einsum_attention(qkv, counts):
    """Per-graph softmax attention over the real nodes, differentiable: the
    rows of each graph's real nodes [n, H*F]."""
    out = []
    for b, n in enumerate(counts.tolist()):
        q, k, v = qkv[b, :n].view(n, 3, H, F).unbind(1)
        s = torch.einsum("ihf,jhf->hij", q, k) / math.sqrt(F)
        out.append(torch.einsum("hij,jhf->ihf", torch.softmax(s, -1), v)
                   .reshape(n, H * F))
    return out


def _close(got, want, rel):
    """got within rel of want's largest magnitude (vacuous when empty)."""
    if not want.numel():
        return True
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.parametrize("n", [0, 1, 7, 12, 45, N])
def test_plain_matches_sdpa_and_einsum(n):
    """Forward and d(qkv) of the plain versions against autograd through
    the einsum softmax and through the SDPA path (key-mask channel), for a
    graph of n real nodes beside one of 5: n = 0 (empty), 1, 7, 12, 45 (no
    tile multiple) and the full N."""
    qkv, gout, counts = _inputs([n, 5], seed=n)
    out, lse = graph_attn.graph_attn_plain(qkv, counts, H)
    dqkv = graph_attn.graph_attn_backward_plain(qkv, counts, out, lse, gout, H)
    mask = (torch.arange(N)[None] < counts[:, None]).float()

    x = qkv.clone().requires_grad_(True)
    want = _einsum_attention(x, counts)
    sum((w * gout[b, :len(w)]).sum() for b, w in enumerate(want)).backward()
    y = qkv.clone().requires_grad_(True)
    sdpa = _sdpa_attention(y, H, mask)
    (sdpa * gout * mask[..., None]).sum().backward()

    for b, m in enumerate(counts.tolist()):
        assert _close(out[b, :m], want[b].detach(), 1e-5)
        assert _close(out[b, :m], sdpa[b, :m].detach(), 1e-5)
    assert _close(dqkv, x.grad, 1e-4)
    assert _close(dqkv, y.grad, 1e-4)


@pytest.mark.parametrize("counts", [[0, 9], [9, 0], [0, 0]])
def test_padded_rows_and_empty_graphs_are_zero(counts):
    """Padded rows of out and of d(qkv) (so the padded keys' dk and dv) are
    exactly 0 whatever the padded rows of qkv and gout hold; a graph with
    no real node gives zeros and no NaN; lse is +inf on padded rows; the
    real rows equal those of inputs with zero padding."""
    qkv, gout, c = _inputs(counts, seed=3, garbage=1e3)
    out, lse = graph_attn.graph_attn_plain(qkv, c, H)
    dqkv = graph_attn.graph_attn_backward_plain(qkv, c, out, lse, gout, H)
    clean_qkv, clean_gout, _ = _inputs(counts, seed=3)
    clean_out, clean_lse = graph_attn.graph_attn_plain(clean_qkv, c, H)
    clean_d = graph_attn.graph_attn_backward_plain(clean_qkv, c, clean_out,
                                                   clean_lse, clean_gout, H)
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    for b, n in enumerate(counts):
        assert torch.equal(out[b, n:], torch.zeros_like(out[b, n:]))
        assert torch.equal(dqkv[b, n:], torch.zeros_like(dqkv[b, n:]))
        assert (lse[b, :, n:] == math.inf).all()
        assert torch.equal(out[b, :n], clean_out[b, :n])
        assert torch.equal(dqkv[b, :n], clean_d[b, :n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_on_cpu(dtype):
    """`attention` trains through GraphAttention (the plain forward and
    backward on the CPU, no launch counted) and serves without lse; the
    output and gradient keep qkv's dtype."""
    qkv, gout, counts = _inputs([23, 7], seed=5)
    qkv, gout = qkv.to(dtype), gout.to(dtype)
    before = (graph_attn.graph_attn.launches, graph_attn.graph_attn_backward.launches)
    x = qkv.clone().requires_grad_(True)
    out = graph_attn.attention(x, counts, H)
    out.backward(gout)
    want_out, lse = graph_attn.graph_attn_plain(qkv, counts, H)
    assert out.dtype == x.grad.dtype == dtype
    assert torch.equal(out, want_out)
    assert torch.equal(x.grad, graph_attn.graph_attn_backward_plain(
        qkv, counts, want_out, lse, gout, H))
    with torch.no_grad():
        assert torch.equal(graph_attn.attention(qkv, counts, H), want_out)
    assert graph_attn.graph_attn_plain(qkv, counts, H, save=False)[1] is None
    assert (graph_attn.graph_attn.launches,
            graph_attn.graph_attn_backward.launches) == before


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_cuda_wrapper_raises_without_the_library(which, monkeypatch):
    """On a tensor off the CPU the wrappers build and launch the kernels or
    raise: with no library they raise, and never take the plain version
    (meta tensors: no memory, no card)."""
    def no_toolkit():
        raise RuntimeError("no CUDA toolkit found")

    monkeypatch.setattr(graph_attn, "_LIB", None)
    monkeypatch.setattr(graph_attn, "build", no_toolkit)
    meta = dict(device="meta")
    qkv = torch.empty((2, N, 3 * H * F), dtype=torch.bfloat16, **meta)
    counts = torch.empty((2,), dtype=torch.int32, **meta)
    out = torch.empty((2, N, H * F), dtype=torch.bfloat16, **meta)
    lse = torch.empty((2, H, N), **meta)
    before = launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        if which == "forward":
            graph_attn.graph_attn(qkv, counts, H)
        else:
            graph_attn.graph_attn_backward(qkv, counts, out, lse, out, H)
    assert launch_counts() == before


@pytest.mark.parametrize("shape,heads,what", [
    ((2, N, 3 * 3 * 33), 3, "head widths 1..32"),
    ((2, N, 100), 3, r"3\*H\*F"),
    ((1, 2 ** 22, 3 * 8 * 32), 8, r"B\*N\*3\*H\*F = 3221225472 >= 2\*\*31"),
], ids=["F=33", "not 3*H*F", "past 32 bits"])
def test_wrappers_refuse_what_the_kernels_do_not_take(shape, heads, what, monkeypatch):
    """Head widths past 32, a width that is no 3*H*F, and offsets past 32
    bits raise ValueError before anything is built."""
    def no_build():
        raise AssertionError("a kernel library was built")

    monkeypatch.setattr(graph_attn, "_LIB", None)
    monkeypatch.setattr(graph_attn, "build", no_build)
    qkv = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    counts = torch.empty((shape[0],), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=what):
        graph_attn.graph_attn(qkv, counts, heads)


@pytest.mark.parametrize("n,pairs", [(0, 0), (1, 128 * 32), (64, 128 * 64),
                                     (65, 128 * 96), (7000, 7040 * 7008),
                                     (8192, 8192 * 8192)])
def test_visited_pairs_are_the_tiles(n, pairs):
    """The pairs the forward computes for a graph of n real nodes: its query
    tiles of 128 by its key tiles of 32."""
    assert graph_attn.visited_pairs(n) == pairs


def test_launch_counts_list_the_attention_wrappers():
    counts = launch_counts()
    assert counts["gps_attn"] == graph_attn.graph_attn.launches
    assert counts["gps_attn_bwd"] == graph_attn.graph_attn_backward.launches
