"""Models found by name. `models/<model>.py`, named as a configuration's
"model" and the port's model factory spell it (`GSpool.py`, `GAT.py`),
provides:

  specs(config)        the seeded weights' (name, shape, bound), in the
                       port's checkpoint leaf order (weights.model_specs)
  forward(config, w, feats, src, dst, graph, prec)
                       node logits [N, C] in plain torch on a union of
                       graphs, `graph` being each node's graph index (int64
                       [N]); it imports nothing of the program
                       (reference/gnn.forward)
  layer_flops(config, n, e)
                       forward FLOPs of each layer over n real nodes and e
                       real edges (flops.gnn_layers)
  KERNELS              the port's own CUDA kernels the model launches
                       (records.PORT_KERNELS)

A new model is a new file here, and edits nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def names() -> list[str]:
    """The models of the benchmark, by name."""
    return sorted(f[:-3] for f in os.listdir(HERE)
                  if f.endswith(".py") and not f.startswith("_"))


@functools.cache
def load(model: str):
    """The module of `model`, imported once."""
    from ..harness import import_file

    path = os.path.join(HERE, f"{model}.py")
    if not os.path.exists(path):
        raise ValueError(f"no model {model!r}: the benchmark has no {path}")
    return import_file(path, f"benchmark.models.{model}")


def hyperparams(cls, config: dict, train: bool = False):
    """The program's hyperparameters (the dataclass `cls`) of a
    configuration: every top-level key that is a field of `cls` and, with
    `train`, every key of its "train" block; the filter of
    `HyperParams.from_json`. Lists are copied."""
    known = {f.name for f in dataclasses.fields(cls)}
    items = dict(config, **config["train"]) if train else config
    return cls(**{k: list(v) if isinstance(v, list) else v
                  for k, v in items.items() if k in known})
