"""Checkpoints in the JAX package's format, read and written without JAX
(counterpart of gnn_tumor_seg_tpu/train/checkpoint.py).

Format: one .npz holding the parameter leaves as `p/{i}` in JAX's pytree
flatten order (convert.py), optionally the optimizer state's leaves as
`o/{i}` in optax's flatten order (train/optim.py), plus a `__manifest__`
JSON (model type, HyperParams, leaf counts `n_params` and `n_opt`, and
`extra`, where the trainer records the epoch). The JAX loaders rebuild their
trees from templates and read only the counts of the manifest, so a
checkpoint written here loads there, and the reverse.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from ..config import HyperParams
from ..convert import (CNN_KEYS, cnn_params_from_jax, cnn_params_to_jax,
                       gnn_params_from_jax, load_gnn_params)
from ..models.factory import GRAPH_MODEL_TYPES, SAGE_AGGREGATORS, init_graph_net
from ..models.gat import GAT
from ..models.refine_cnn import CnnRefinementNet
from ..models.sage import LAYER_KEYS, GraphSage

__all__ = ["save_checkpoint", "load_checkpoint", "load_opt_state",
           "gnn_from_leaves", "cnn_from_leaves"]

_MANIFEST_KEY = "__manifest__"


def _leaves(model) -> tuple[list[np.ndarray], str]:
    if isinstance(model, (GraphSage, GAT)):
        leaves = [p.detach().cpu().numpy() for p in model.jax_parameters()]
        keys = ([list(layer.keys) for layer in model.layers]
                if isinstance(model, GAT) else list(LAYER_KEYS[model.aggregator]))
        return leaves, f"list of {model.num_layers} dicts {keys}"
    if isinstance(model, CnnRefinementNet):
        params = cnn_params_to_jax(model)
        return ([params[a][b] for a, b in CNN_KEYS],
                f"dict {['/'.join(k) for k in CNN_KEYS]}")
    raise TypeError(f"cannot checkpoint a {type(model).__name__}")


def save_checkpoint(path: str, model, model_type: str, hp: HyperParams,
                    opt_state: list[np.ndarray] | None = None,
                    extra: dict | None = None) -> None:
    """Write `model` (a GraphSage, GAT or CnnRefinementNet) with its config
    and, when given, the optimizer state's leaves
    (train/optim.opt_state_leaves); atomic (temporary file renamed into
    place)."""
    leaves, treedef = _leaves(model)
    manifest = {
        "model_type": model_type,
        "hyperparams": json.loads(hp.to_json()),
        "treedef": treedef,
        "n_params": len(leaves),
        "extra": extra or {},
        "format_version": 1,
    }
    payload = {f"p/{i}": np.asarray(v, np.float32) for i, v in enumerate(leaves)}
    if opt_state is not None:
        payload.update({f"o/{i}": np.asarray(v) for i, v in enumerate(opt_state)})
        manifest["n_opt"] = len(opt_state)
        manifest["opt_treedef"] = "optax inject_hyperparams(adamw) state leaves"
    payload[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str):
    """Returns (leaves list[np.ndarray], model_type, HyperParams, manifest)."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z[_MANIFEST_KEY].tobytes()).decode())
        leaves = [z[f"p/{i}"] for i in range(manifest["n_params"])]
    hp = HyperParams.from_json(json.dumps(manifest["hyperparams"]))
    return leaves, manifest["model_type"], hp, manifest


def load_opt_state(path: str) -> list[np.ndarray] | None:
    """The optimizer state's leaves saved beside the parameters, or None if
    the checkpoint was saved without them."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z[_MANIFEST_KEY].tobytes()).decode())
        n_opt = manifest.get("n_opt")
        if not n_opt:
            return None
        return [z[f"o/{i}"] for i in range(n_opt)]


def gnn_from_leaves(leaves: list[np.ndarray], model_type: str, hp: HyperParams,
                    device="cpu") -> GraphSage | GAT:
    """A GraphSage or GAT of `model_type` from checkpoint leaves (JAX
    flatten order). A GAT's layer specs, and which of its layers carry
    w_res, come from the checkpoint's HyperParams."""
    if model_type == "GAT":
        model = init_graph_net("GAT", hp)
        n = len(model.jax_parameters())
        if len(leaves) != n:
            raise ValueError(f"{len(leaves)} leaves for a GAT of {n} parameters")
        it = iter(leaves)
        load_gnn_params(model, [{k: next(it) for k in layer.keys}
                                for layer in model.layers])
        return model.to(device)
    if model_type not in SAGE_AGGREGATORS:
        raise NotImplementedError(
            f"{model_type} checkpoints need a model the port does not have "
            f"yet (ROADMAP.md); ported: {GRAPH_MODEL_TYPES}")
    keys = LAYER_KEYS[SAGE_AGGREGATORS[model_type]]
    k = len(keys)
    if len(leaves) % k:
        raise ValueError(f"{len(leaves)} leaves are not a whole number of "
                         f"{model_type} layers ({k} leaves each)")
    params = [dict(zip(keys, leaves[i:i + k]))
              for i in range(0, len(leaves), k)]
    return gnn_params_from_jax(params, dropout=hp.feature_dropout or 0.0,
                               device=device)


def cnn_from_leaves(leaves: list[np.ndarray], device="cpu") -> CnnRefinementNet:
    """A CnnRefinementNet from checkpoint leaves (JAX flatten order)."""
    if len(leaves) != len(CNN_KEYS):
        raise ValueError(f"expected {len(CNN_KEYS)} CNN leaves, got {len(leaves)}")
    params: dict = {"conv0": {}, "conv1": {}}
    for (a, b), leaf in zip(CNN_KEYS, leaves):
        params[a][b] = leaf
    return cnn_params_from_jax(params, device=device)
