"""cli.import_torch_weights: the port's CLI against the JAX package's on the
same torch state_dicts, built in process from seeded numpy arrays in the
layouts gnn_tumor_seg_tpu/cli/import_torch_weights.py documents (the
reference's CnnRefinementNet, including the 9-in/5-out layout of its
provided CNN weights, and DGL SAGEConv/GATConv stacks under `layers.{i}.`).

Both CLIs turn one `.pt` into checkpoints whose parameter leaves are bitwise
equal and whose manifests carry equal HyperParams; the port's forward on
its checkpoint is within rtol/atol 1e-5 of the JAX forward on the JAX one
("exact"; the CNN's within 1e-5 of its largest logit, with conv weights at
torch's init scale). A state_dict without `layers.*` keys raises ValueError in both.
"""

import numpy as np
import pytest
import torch

from gnn_tumor_seg_tpu.cli import import_torch_weights as jax_cli
from gnn_tumor_seg_tpu.cli.common import load_cnn_from_checkpoint as jax_load_cnn
from gnn_tumor_seg_tpu.cli.common import load_gnn_from_checkpoint as jax_load_gnn
from gnn_tumor_seg_tpu.data.synthetic import random_graph
from gnn_tumor_seg_tpu.ops.graph import graph_from_arrays as jax_graph_from_arrays
from gnn_tumor_seg_tpu.ops.pallas.precision import precision_scope as jax_precision
from gnn_tumor_seg_tpu_torch.cli import import_torch_weights as port_cli
from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                load_gnn_from_checkpoint)
from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays
from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
from gnn_tumor_seg_tpu_torch.train.checkpoint import load_checkpoint


def _t(rng, *shape, scale=0.3):
    return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32))


def cnn_state_dict(rng, in_ch=8, hidden=16, out=4, k=5):
    """Conv weights at torch's Conv3d init scale, 1 / sqrt(fan_in)."""
    s0, s1 = (in_ch * k ** 3) ** -0.5, (hidden * k ** 3) ** -0.5
    return {"conv_layers.0.weight": _t(rng, hidden, in_ch, k, k, k, scale=s0),
            "conv_layers.0.bias": _t(rng, hidden, scale=s0),
            "conv_layers.1.weight": _t(rng, out, hidden, k, k, k, scale=s1),
            "conv_layers.1.bias": _t(rng, out, scale=s1)}


def sage_state_dict(rng, aggregator, dims=(20, 8, 8, 4)):
    sd = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        pre = f"layers.{i}."
        sd[pre + "fc_neigh.weight"] = _t(rng, b, a)
        sd[pre + "bias"] = _t(rng, b)
        if aggregator != "gcn":
            sd[pre + "fc_self.weight"] = _t(rng, b, a)
        if aggregator == "pool":
            sd[pre + "fc_pool.weight"] = _t(rng, a, a)
            sd[pre + "fc_pool.bias"] = _t(rng, a)
    return sd


# (in, heads, features, projected residual) per layer: an identity
# residual is possible on layer 1 (in 8 == 2 x 4), a projected one on
# layer 2 (in 8 -> 3 x 4)
GAT_LAYERS = [(20, 2, 4, False), (8, 2, 4, False), (8, 3, 4, True), (12, 1, 4, False)]


def gat_state_dict(rng):
    sd = {}
    for i, (a, h, f, res) in enumerate(GAT_LAYERS):
        pre = f"layers.{i}."
        sd[pre + "fc.weight"] = _t(rng, h * f, a)
        sd[pre + "attn_l"] = _t(rng, 1, h, f)
        sd[pre + "attn_r"] = _t(rng, 1, h, f)
        sd[pre + "bias"] = _t(rng, h * f)
        if res:
            sd[pre + "res_fc.weight"] = _t(rng, h * f, a)
    return sd


CASES = {
    "CNN": (lambda rng: cnn_state_dict(rng), "CNN", []),
    "CNN-9in-5out": (lambda rng: cnn_state_dict(rng, in_ch=9, out=5), "CNN", []),
    "GSpool": (lambda rng: sage_state_dict(rng, "pool"), "GSpool", []),
    "GSmean": (lambda rng: sage_state_dict(rng, "mean"), "GSmean", []),
    "GSgcn": (lambda rng: sage_state_dict(rng, "gcn"), "GSgcn", []),
    "GAT-projected": (gat_state_dict, "GAT", []),
    "GAT-identity": (gat_state_dict, "GAT", ["--gat_residuals", "0,1,1,0"]),
}


def _import_both(tmp_path, name):
    make, model_type, extra = CASES[name]
    pt = str(tmp_path / f"{name}.pt")
    torch.save(make(np.random.default_rng(7)), pt)
    paths = {}
    for tag, cli in (("jax", jax_cli), ("port", port_cli)):
        paths[tag] = str(tmp_path / f"{name}_{tag}.ckpt")
        cli.main(["-i", pt, "-o", paths[tag], "-t", model_type, *extra])
    return paths


@pytest.mark.parametrize("name", list(CASES))
def test_import_matches_jax(tmp_path, name):
    paths = _import_both(tmp_path, name)
    jl, jtype, jhp, jman = load_checkpoint(paths["jax"])
    pl, ptype, php, pman = load_checkpoint(paths["port"])
    assert ptype == jtype and pman["hyperparams"] == jman["hyperparams"]
    assert php == jhp and pman["extra"] == jman["extra"]
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rng = np.random.default_rng(1)
    if jtype == "CNN":
        x = rng.normal(size=(1, 12, 10, 8, php.in_feats)).astype(np.float32)
        *_, jfwd = jax_load_cnn(paths["jax"])
        _, _, fwd = load_cnn_from_checkpoint(paths["port"], device="cpu")
        with jax_precision("exact"):
            want = np.asarray(jfwd(x))
        with precision_scope("exact"):
            got = fwd(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape and got.shape[-1] == php.out_classes
        # two convolutions of 125 taps a channel summed in another order
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        return
    feats, src, dst, _ = random_graph(rng, 60, avg_deg=4, f_dim=php.in_feats)
    *_, jfwd = jax_load_gnn(paths["jax"])
    _, _, fwd = load_gnn_from_checkpoint(paths["port"], device="cpu")
    with jax_precision("exact"):
        want = np.asarray(jfwd(jax_graph_from_arrays(feats, src, dst)))
    with precision_scope("exact"):
        got = fwd(graph_from_arrays(feats, src, dst)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gat_residual_flags_reach_the_model(tmp_path):
    """--gat_residuals gives layer 1 its identity residual (no parameter);
    without it only the projected residual of layer 2 is inferred."""
    for name, want in (("GAT-projected", [False, False, True]),
                       ("GAT-identity", [False, True, True])):
        paths = _import_both(tmp_path, name)
        model, hp, _ = load_gnn_from_checkpoint(paths["port"], device="cpu")
        assert hp.gat_residuals == want and hp.gat_heads == [2, 2, 3]
        assert [layer.residual for layer in model.layers] == want + [False]
        assert [layer.w_res is not None for layer in model.layers] == [
            False, False, True, False]


def test_not_a_gnn_state_dict_raises_in_both(tmp_path):
    pt = str(tmp_path / "cnn.pt")
    torch.save(cnn_state_dict(np.random.default_rng(0)), pt)
    for cli in (jax_cli, port_cli):
        with pytest.raises(ValueError, match="layers"):
            cli.main(["-i", pt, "-o", str(tmp_path / "x.ckpt"), "-t", "GSpool"])
    assert not (tmp_path / "x.ckpt").exists()


def test_cli_prints_the_inferred_architecture(tmp_path, capsys):
    _import_both(tmp_path, "CNN-9in-5out")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].split("->")[1] != out[1].split("->")[1]
    for line in out:
        assert "(CNN, in=9, out=5, layers=[16])" in line
