"""Checkpoints in the JAX package's format, read and written without JAX
(counterpart of gnn_tumor_seg_tpu/train/checkpoint.py).

Format: one .npz holding the parameter leaves as `p/{i}` in JAX's pytree
flatten order (convert.py), optionally the optimizer state's leaves as
`o/{i}` in optax's flatten order (train/optim.py), plus a `__manifest__`
JSON (model type, HyperParams, leaf counts `n_params` and `n_opt`, and
`extra`, where the trainer records the epoch). The JAX loaders rebuild their
trees from templates and read only the counts of the manifest, so a
checkpoint written here loads there, and the reverse.

A graph model's leaves are its `jax_parameters()` (JAX's flatten order for
GraphSage and GAT; a GPS's own order, GPS.leaf_names) and, as `b/{i}` with
the count `n_buffers`, its torch buffers where it has any (a GPS's
BatchNorms' running statistics, which evaluation and serving read);
load_checkpoint returns them in the manifest, as `buffers`. Writing and
reading (convert.load_leaves) take the same path for every graph model, so
a new one joins with its jax_parameters(), any state it carries registered
as buffers in leaf order, and its entry in models/factory.init_graph_net.
Only the CNN, whose weights change layout (OIDHW to DHWIO), has a path of
its own.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..config import HyperParams
from ..convert import (CNN_KEYS, cnn_params_from_jax, cnn_params_to_jax,
                       load_leaves, parameter_names)
from ..models.factory import init_graph_net
from ..models.refine_cnn import CnnRefinementNet

__all__ = ["save_checkpoint", "load_checkpoint", "load_opt_state",
           "gnn_from_leaves", "cnn_from_leaves"]

_MANIFEST_KEY = "__manifest__"


def _leaves(model) -> tuple[list[np.ndarray], str]:
    if isinstance(model, CnnRefinementNet):
        params = cnn_params_to_jax(model)
        return ([params[a][b] for a, b in CNN_KEYS],
                f"dict {['/'.join(k) for k in CNN_KEYS]}")
    return ([p.detach().cpu().numpy() for p in model.jax_parameters()],
            f"{type(model).__name__} leaves {parameter_names(model)}")


def save_checkpoint(path: str, model, model_type: str, hp: HyperParams,
                    opt_state: list[np.ndarray] | None = None,
                    extra: dict | None = None) -> None:
    """Write `model` (a graph model or a CnnRefinementNet) with its config
    (and its buffers, where it has any) and, when given, the optimizer
    state's leaves (train/optim.opt_state_leaves); atomic (temporary file
    renamed into place)."""
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
    buffers = [b.detach().cpu().numpy() for b in model.buffers()]
    if buffers:
        payload.update({f"b/{i}": np.asarray(v, np.float32)
                        for i, v in enumerate(buffers)})
        manifest["n_buffers"] = len(buffers)
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
    """Returns (leaves list[np.ndarray], model_type, HyperParams, manifest).
    Where the checkpoint has buffer leaves (a GPS's running statistics), the
    manifest holds them as `buffers`, a list[np.ndarray]."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z[_MANIFEST_KEY].tobytes()).decode())
        leaves = [z[f"p/{i}"] for i in range(manifest["n_params"])]
        if manifest.get("n_buffers"):
            manifest["buffers"] = [z[f"b/{i}"] for i in range(manifest["n_buffers"])]
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
                    device="cpu", buffers: list[np.ndarray] | None = None
                    ) -> torch.nn.Module:
    """The graph model of `model_type` that the checkpoint's HyperParams
    describe (models/factory.init_graph_net), holding its leaves and, when
    given, its buffer leaves (the manifest's `buffers`; without them a GPS's
    running statistics stay at their initial values)."""
    model = init_graph_net(model_type, hp)
    load_leaves(model, leaves, buffers)
    return model.to(device)


def cnn_from_leaves(leaves: list[np.ndarray], device="cpu") -> CnnRefinementNet:
    """A CnnRefinementNet from checkpoint leaves (JAX flatten order)."""
    if len(leaves) != len(CNN_KEYS):
        raise ValueError(f"expected {len(CNN_KEYS)} CNN leaves, got {len(leaves)}")
    params: dict = {"conv0": {}, "conv1": {}}
    for (a, b), leaf in zip(CNN_KEYS, leaves):
        params[a][b] = leaf
    return cnn_params_from_jax(params, device=device)
