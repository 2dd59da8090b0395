"""Carry weights between the JAX package's parameter pytrees and the port's modules.

The JAX GraphSage's and GAT's parameters are a list (one per layer) of dicts
of matrices and vectors; the port keeps the same layouts, so they copy over
as they are. The JAX CNN's are {"conv0": {"w", "b"}, "conv1": {...}} with
DHWIO weights; the port's are OIDHW.

The flat leaf order is JAX's pytree flatten order (list index first, then
dict keys sorted): for a pool layer b_pool, bias, w_neigh, w_pool, w_self;
for a mean layer bias, w_neigh, w_self; for a gcn layer bias, w_neigh
(models/sage.py:LAYER_KEYS); for a GAT layer attn_l, attn_r, bias, w and,
on a residual layer whose width changes, w_res (models/gat.py,
GatConv.keys); for the CNN conv0/b, conv0/w, conv1/b, conv1/w.
train/checkpoint.py stores leaves in that order, so one checkpoint file
loads in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gat import GAT
from .models.refine_cnn import CnnRefinementNet
from .models.sage import LAYER_KEYS, GraphSage

__all__ = ["gnn_params_from_jax", "gnn_params_to_jax", "gat_params_from_jax",
           "gat_params_to_jax", "cnn_params_from_jax", "cnn_params_to_jax",
           "aggregator_of", "load_gnn_params", "CNN_KEYS"]
CNN_KEYS = (("conv0", "b"), ("conv0", "w"), ("conv1", "b"), ("conv1", "w"))
_CNN_ATTRS = {("conv0", "w"): "w0", ("conv0", "b"): "b0",
              ("conv1", "w"): "w1", ("conv1", "b"): "b1"}
_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)
_OIDHW_TO_DHWIO = (2, 3, 4, 1, 0)


def _copy_into(param: torch.nn.Parameter, value, name: str) -> None:
    value = torch.tensor(np.asarray(value, np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not match "
                         f"the model's {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def aggregator_of(params: list[dict]) -> str:
    """The SAGE aggregator whose layer keys `params` (the JAX GraphSage
    parameter list) carry."""
    for agg, keys in LAYER_KEYS.items():
        if all(set(lp) == set(keys) for lp in params):
            return agg
    raise ValueError(f"layer keys {[sorted(lp) for lp in params]} are not "
                     f"those of one SAGE aggregator: {LAYER_KEYS}")


def gnn_params_from_jax(params: list[dict], dropout: float = 0.0,
                        device="cpu") -> GraphSage:
    """A GraphSage holding the JAX GraphSage parameters `params` (list of
    per-layer dicts of numpy arrays); the aggregator is read from the keys
    and the widths from the shapes."""
    agg = aggregator_of(params)
    dims = [np.shape(params[0]["w_neigh"])[0]] + [
        np.shape(lp["w_neigh"])[1] for lp in params]
    model = GraphSage(dims[0], dims[1:-1], dims[-1], dropout, aggregator=agg)
    load_gnn_params(model, params)
    return model.to(device)


def load_gnn_params(model: GraphSage | GAT, params: list[dict]) -> None:
    """Copy the JAX GraphSage or GAT parameters `params` into `model`'s own
    parameters in place (an optimizer holding them keeps them)."""
    if len(params) != model.num_layers:
        raise ValueError(f"{len(params)} layers of parameters for a model of "
                         f"{model.num_layers}")
    for i, (layer, lp) in enumerate(zip(model.layers, params)):
        keys = (layer.keys if isinstance(model, GAT)
                else LAYER_KEYS[model.aggregator])
        if set(lp) != set(keys):
            raise ValueError(f"layer {i}: keys {sorted(lp)} are not the "
                             f"model's layer keys {list(keys)}")
        for key in keys:
            _copy_into(getattr(layer, key), lp[key], f"layer {i} {key}")


def gnn_params_to_jax(model: GraphSage) -> list[dict]:
    """The JAX GraphSage parameter list (numpy float32) of `model`."""
    return [{key: getattr(layer, key).detach().cpu().numpy()
             for key in LAYER_KEYS[model.aggregator]} for layer in model.layers]


def gat_params_from_jax(params: list[dict], residuals, feat_drop: float = 0.0,
                        device="cpu") -> GAT:
    """A GAT holding the JAX GAT parameters `params` (list of per-layer
    dicts of numpy arrays). The widths and heads are read from the shapes;
    `residuals` (HyperParams.gat_residuals) says which layers add their
    input, which the parameters show only where a w_res projects it."""
    heads = [np.shape(lp["attn_l"])[0] for lp in params]
    widths = [np.shape(lp["attn_l"])[1] for lp in params]
    if heads[-1] != 1:
        raise ValueError(f"the output layer has {heads[-1]} heads; the GAT "
                         "stack's has one")
    model = GAT(np.shape(params[0]["w"])[0], widths[:-1], widths[-1],
                heads[:-1], residuals, feat_drop=feat_drop)
    load_gnn_params(model, params)
    return model.to(device)


def gat_params_to_jax(model: GAT) -> list[dict]:
    """The JAX GAT parameter list (numpy float32) of `model`."""
    return [{key: getattr(layer, key).detach().cpu().numpy()
             for key in layer.keys} for layer in model.layers]


def cnn_params_from_jax(params: dict, device="cpu") -> CnnRefinementNet:
    """A CnnRefinementNet holding the JAX CNN parameters (DHWIO weights)."""
    w0, w1 = np.asarray(params["conv0"]["w"]), np.asarray(params["conv1"]["w"])
    net = CnnRefinementNet(w0.shape[3], w1.shape[4], [w0.shape[4]])
    for (layer, key), attr in _CNN_ATTRS.items():
        value = np.asarray(params[layer][key], np.float32)
        if key == "w":
            value = value.transpose(_DHWIO_TO_OIDHW)
        _copy_into(getattr(net, attr), value, f"{layer}/{key}")
    return net.to(device)


def cnn_params_to_jax(net: CnnRefinementNet) -> dict:
    """The JAX CNN parameter dict (numpy float32, DHWIO weights) of `net`."""
    out: dict = {"conv0": {}, "conv1": {}}
    for (layer, key), attr in _CNN_ATTRS.items():
        value = getattr(net, attr).detach().cpu().numpy()
        out[layer][key] = value.transpose(_OIDHW_TO_DHWIO) if key == "w" else value
    return out
