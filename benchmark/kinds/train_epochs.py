"""Kind `train_epochs`: the GNN trainer `cli/train_gnn.py` drives,
`train.gnn_trainer.GNNTrainer.run_epoch`, epochs back to back over a
BraTS-sized training set held as the trainer holds it (graphs padded to
their bucket, copied once into its device cache).

Set-up draws `graphs` distinct graphs and the configuration's weights
from the seed; the epoch's `epoch_graphs` entries cycle over them so that
the first batches of epoch 0 hold distinct graphs. It builds one trainer,
copies the weights into it, and runs epoch 0 (every shape, and the device
cache filled), then takes a copy of the state the window starts from
(parameters, AdamW's moments and step count). The window runs further
epochs until `seconds` have passed; every epoch started in it completes
and counts.

Two stretches of `check_steps` steps are judged, each by the loss of its
steps, its first gradient (from AdamW's first moment before and after the
step) and the parameters after it: the first steps of epoch 0, which the
reference takes from the seed's weights (`loss_err`, `grad_err`,
`change_err`), and the first steps of the window's first epoch, graphs
read from the device cache, which the reference takes from the copied
state at that epoch's learning rate and shuffle (`window_loss_err`,
`window_grad_err`, `window_change_err`).

The trainer pads every batch to the degree bucket of its whole training
set (`shape_budget`). The `graphs` distinct graphs of a run reach a degree
of 16 or 17 by seed, where the set of `epoch_graphs` distinct graphs that
an epoch stands for reaches more; so the data's degree budget is at least
`degree_budget`, and every seed pads to the same bucket: the seed does not
choose the work of a step.

Traffic parameters: epoch_graphs, graphs, nodes, grid, k, degree_budget,
precision, check_steps.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .. import flops, inputs, models, weights
from ..reference import train as ref_train
from ..reference.precision import REFERENCE


class EpochData:
    """The trainer's data protocol over `epoch_graphs` entries, entry i
    being graph `graph_of[i]` (host graphs, as a dataset returns them)."""

    def __init__(self, graphs, graph_of, degree_budget: int):
        self.graphs = graphs
        self.graph_of = graph_of
        self.degree_budget = degree_budget
        self.ids = [f"entry_{i:05d}" for i in range(len(graph_of))]

    def __len__(self):
        return len(self.graph_of)

    def get_graph(self, i):
        return self.graphs[self.graph_of[i]]

    def shape_budget(self):
        return (max(g.num_nodes_padded for g in self.graphs),
                max(self.degree_budget, *(g.max_degree for g in self.graphs)))


# epochs the set-up runs: the window starts at this epoch
WARM_EPOCHS = 1


def _epoch_order(seed: int, n: int, epoch: int = 0) -> np.ndarray:
    """The trainer's shuffle of epoch `epoch`."""
    return np.random.default_rng((seed, epoch)).permutation(n)


def _epoch_lr(train: dict, epoch: int) -> float:
    """The learning rate of epoch `epoch`: lr * lr_decay**epoch in float32."""
    return float(np.float32(train["lr"]) * np.float32(train["lr_decay"])
                 ** np.float32(epoch))


def _batches(coo, graph_of, order, bs: int, steps: int):
    return [[coo[graph_of[i]] for i in order[s * bs:(s + 1) * bs]]
            for s in range(steps)]


def _hp(cfg: dict):
    from gnn_tumor_seg_tpu_torch.config import HyperParams

    return models.hyperparams(HyperParams, cfg, train=True)


def make_inputs(run) -> dict:
    """The weights, the distinct graphs (numpy COO), the graph of each
    epoch entry and the first batches of epoch 0, from the seed."""
    cfg, dev = run.cell.config, run.device
    specs = weights.model_specs(cfg)
    gen = inputs.seed_generator(run.seed, dev, 2)
    coo = [inputs.make_train_graph(gen, run.param("nodes"), tuple(run.param("grid")),
                                   run.param("k"), cfg["in_feats"])
           for _ in range(run.param("graphs"))]
    tseed = run.seed % 2**32
    n = run.param("epoch_graphs")
    order = _epoch_order(tseed, n)
    graph_of = np.empty(n, np.int64)
    graph_of[order] = np.arange(n) % len(coo)
    bs, steps = cfg["train"]["batch_size"], run.param("check_steps")
    return {"specs": specs, "coo": coo, "graph_of": graph_of, "tseed": tseed,
            "weights": weights.draw(specs, inputs.seed_generator(run.seed, dev, 1)),
            "batches": _batches(coo, graph_of, order, bs, steps),
            "lrs": [_epoch_lr(cfg["train"], 0)] * steps,
            "window_batches": _batches(coo, graph_of,
                                       _epoch_order(tseed, n, WARM_EPOCHS), bs, steps),
            "window_lrs": [_epoch_lr(cfg["train"], WARM_EPOCHS)] * steps}


def _moments(trainer, named) -> dict:
    """AdamW's first moment of each parameter by name (0 where the
    optimizer holds none)."""
    return {name: trainer.optimizer.state.get(p, {}).get(
        "exp_avg", torch.zeros_like(p)).detach().clone() for name, p in named}


def _snapshot(trainer, named):
    """The state the next step starts from: parameters, and AdamW's first
    and second moments and step count."""
    state = [trainer.optimizer.state.get(p, {}) for _, p in named]
    steps = {int(s["step"]) for s in state if "step" in s}
    return ({name: p.detach().clone() for name, p in named},
            (_moments(trainer, named),
             {name: s["exp_avg_sq"].detach().clone()
              for (name, _), s in zip(named, state) if "exp_avg_sq" in s},
             max(steps, default=0)))


def _keep_steps(trainer, named, n_check: int) -> dict:
    """Wraps the trainer's step to keep, of the next `n_check` steps, the
    losses, AdamW's first moment after the first and the parameters after
    the last; `del trainer._step` ends it."""
    kept = {"losses": []}
    step = trainer._step

    def keeping_step(batch, generator):
        loss = step(batch, generator)
        k = len(kept["losses"])
        if k < n_check:
            kept["losses"].append(loss)
            if k == 0:
                kept["m1"] = _moments(trainer, named)
            if k == n_check - 1:
                kept["params"] = {name: p.detach().clone() for name, p in named}
        return loss

    trainer._step = keeping_step
    return kept


def setup(run):
    from gnn_tumor_seg_tpu_torch.ops.graph import (DEGREE_BUCKETS, bucket_size,
                                                   graph_from_arrays)
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer

    cfg, dev = run.cell.config, run.device
    run.mark("imports")
    made = make_inputs(run)
    run.mark("inputs")
    specs, coo, w = made["specs"], made["coo"], made["weights"]
    graphs = [graph_from_arrays(f, s, d, y, rslot=True) for f, s, d, y in coo]
    run.mark("ell tables")
    data = EpochData(graphs, made["graph_of"], run.param("degree_budget"))
    tseed, n = made["tseed"], len(made["graph_of"])
    trainer = GNNTrainer(cfg["model"], _hp(cfg), data, seed=tseed,
                         precision=run.param("precision"), device=dev)
    params = trainer.model.jax_parameters()
    weights.load_into(params, w, specs)
    run.mark("trainer")

    named = [(name, p) for (name, _, _), p in zip(specs, params)]
    kept = _keep_steps(trainer, named, run.param("check_steps"))
    try:
        trainer.run_epoch()
    finally:
        del trainer._step
    run.mark("warm epoch")
    start = _snapshot(trainer, named)
    window_kept = _keep_steps(trainer, named, run.param("check_steps"))
    bs = cfg["train"]["batch_size"]
    # the shapes the roofline readers need, from the padded graphs; every
    # batch's neighbour table is as wide as the data's degree budget's bucket
    ell = [(int(g.nbr_mask.any(-1).sum()), int(g.nbr_mask.sum())) for g in graphs]
    shapes = {"B": bs, "N": graphs[0].num_nodes_padded,
              "D": bucket_size(data.shape_budget()[1], DEGREE_BUCKETS),
              "es": 2 if run.param("precision") == "fast" else 4,
              "referenced": bs * float(np.mean([r for r, _ in ell])),
              "live": bs * float(np.mean([r for r, _ in ell]))}
    step_flops = bs * float(np.mean([flops.gnn_train_step(cfg, len(f), len(s))
                                     for f, s, _, _ in coo]))
    return {"trainer": trainer, "made": made, "kept": kept,
            "window_kept": window_kept, "start": start, "shapes": shapes,
            "step_flops": step_flops, "epoch": n}


def window(state, run) -> dict:
    trainer = state["trainer"]
    epochs, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        # the first epoch of a traced run: device activity only (tracing
        # the host's ops as well slows its 209 host-paced steps ~20x)
        region = (run.tracer.region(host_spans=False) if not epochs
                  else contextlib.nullcontext())
        t = time.perf_counter()
        try:
            with region:
                trainer.run_epoch()
        except Exception as exc:          # counts, and ends the window
            failed += 1
            print(f"epoch failed: {exc!r}", flush=True)
            break
        finally:
            if not epochs and "_step" in vars(trainer):
                del trainer._step         # the judged steps are kept
        wall = time.perf_counter() - t
        steps = trainer.last_epoch_stats["steps"]
        attempted += steps
        epochs.append({"wall": wall, "steps": steps, "graphs": state["epoch"],
                       "traced": run.trace and not epochs})
    print("epoch walls " + " ".join(f"{e['wall']:.4f}" for e in epochs),
          file=sys.stderr)
    total = sum(e["wall"] for e in epochs)
    cfg = run.cell.config
    return {"attempted": attempted, "failed": failed,
            "e2e": {"train_samples_per_s":
                    sum(e["graphs"] for e in epochs) / max(total, 1e-30)},
            "record": {"kind": "train", "epochs": epochs,
                       "precision": run.param("precision"), "config": cfg,
                       "shapes": state["shapes"], "step_flops": state["step_flops"]}}


def _record(kept: dict, m_before: dict) -> dict:
    """What the judged steps produced, as reference/train.compare reads it."""
    if "m1" not in kept:
        return {}
    return {"losses": [float(x) for x in kept["losses"]],
            "grad": ref_train.first_gradient(m_before, kept["m1"]),
            "params": kept.get("params", {})}


def _judged(made: dict, start, prec, record, window_record) -> dict:
    """The numbers of both judged stretches: `record` from the seed's
    weights, `window_record` from the window's starting state `start`."""
    cfg, dev = made["config"], made["device"]
    numbers = ref_train.compare(record, cfg, cfg["train"], made["weights"],
                                made["batches"], made["lrs"], prec, dev)
    params, moments = start
    window = ref_train.compare(window_record, cfg, cfg["train"], params,
                               made["window_batches"], made["window_lrs"],
                               prec, dev, moments)
    numbers.update({f"window_{k}": v for k, v in window.items()})
    return numbers


def judge(state, run) -> dict:
    """After the window: the program's state is freed, then the reference
    takes the judged steps from the same weights, or the same state."""
    del state["trainer"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    made = dict(state["made"], config=run.cell.config, device=run.device)
    start = state["start"]
    return _judged(made, start, REFERENCE, _record(state["kept"], {}),
                   _record(state["window_kept"], start[1][0]))


def control(run, prec) -> dict:
    """The reference in `prec` put in the program's place, judged as the
    program is: from the seed's weights, and from the state the program's
    set-up hands the window."""
    state = setup(run)
    del state["trainer"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = run.cell.config
    made = dict(state["made"], config=cfg, device=run.device)
    params, moments = state["start"]

    def record(weights, batches, lrs, start_moments=None):
        losses, grad, after = ref_train.steps(cfg, cfg["train"], weights, batches,
                                              lrs, prec, run.device, start_moments)
        return {"losses": losses, "grad": grad, "params": after}

    return _judged(made, state["start"], REFERENCE,
                   record(made["weights"], made["batches"], made["lrs"]),
                   record(params, made["window_batches"], made["window_lrs"],
                          moments))
