"""Rank workers of the port's distributed tests (tests/test_torch_port_parallel.py).

Imports only torch, numpy and the port, never JAX: the workers run in
spawned children, which import this module by name. `run_world` starts one
process per rank with the spawn method and gives the world a deadline: if
the ranks have not all finished by then, it kills them and raises, so a
hang costs the suite one deadline, not its whole time limit. Every worker
joins a gloo group on the CPU with a short timeout and writes its results
to `<outdir>/<name>_r<rank>.npz`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60.0
CLASS_WEIGHTS = [0.1, 1.0, 2.0, 2.0]


def run_world(fn, world: int, args: tuple = (), deadline_s: float = 120.0) -> None:
    """Run fn(rank, world, init_method, *args) in `world` spawned processes
    over one gloo group; raise if a rank fails or the deadline passes."""
    from gnn_tumor_seg_tpu_torch.parallel.mesh import free_port

    init = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(fn, args=(world, init, *args), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > end:
                raise TimeoutError(f"ranks of {fn.__name__} still running "
                                   f"after {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def _mesh(rank, world, init):
    from gnn_tumor_seg_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    return initialize_multihost(init, world, rank, device="cpu",
                                timeout_s=GROUP_TIMEOUT_S)


def _save(outdir, name, rank, **arrays):
    np.savez(os.path.join(outdir, f"{name}_r{rank}.npz"), **arrays)


def _load_base(model_type, hp, leaves):
    """The port's single-device model with the given JAX-order leaves."""
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net

    model = init_graph_net(model_type, hp)
    with torch.no_grad():
        for p, leaf in zip(model.jax_parameters(), leaves):
            p.copy_(torch.from_numpy(np.asarray(leaf, np.float32)))
    return model


# --------------------------------------------------------------- halo cases


def halo_cases(rank, world, init, outdir, spec_path):
    """For every case of the spec: the halo model's own logits (exact) and
    its global loss and parameter gradients."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.parallel import halo
    from gnn_tumor_seg_tpu_torch.parallel.collectives import all_reduce_grads
    from gnn_tumor_seg_tpu_torch.parallel.mesh import shutdown

    mesh = _mesh(rank, world, init)
    try:
        data = np.load(spec_path)
        cases = json.loads(str(data["cases"]))
        cw = torch.tensor(CLASS_WEIGHTS)
        args = (data["feats"], data["src"], data["dst"], data["labels"], world)
        pgs = {"all_gather": (halo.partition_graph(*args), None),
               "p2p": halo.partition_graph_p2p(*args)}
        out = {}
        for c in cases:
            hp = HyperParams(in_feats=int(data["feats"].shape[1]),
                             layer_sizes=c["layers"],
                             gat_heads=c.get("heads"),
                             gat_residuals=c.get("residuals"))
            leaves = [data[f"{c['name']}/{i}"] for i in range(c["n_leaves"])]
            base = _load_base(c["model_type"], hp, leaves)
            for variant in ("all_gather", "p2p"):
                pg, w = pgs[variant]
                cls = {("GAT", "p2p"): halo.HaloGATP2P,
                       ("GAT", "all_gather"): halo.HaloGAT}.get(
                    (c["model_type"], variant),
                    halo.HaloGraphSageP2P if variant == "p2p"
                    else halo.HaloGraphSage)
                model = cls(base, mesh, w) if variant == "p2p" else cls(base, mesh)
                rg = halo.place_partition(pg, mesh, w)
                key = f"{c['name']}/{variant}"
                with precision_scope("exact"):
                    with torch.no_grad():
                        out[key + "/logits"] = model(rg).numpy()
                    base.zero_grad(set_to_none=True)
                    loss = model.loss(rg, cw)
                    loss.backward()
                all_reduce_grads(base.jax_parameters(), mesh)
                out[key + "/loss"] = np.float64(loss.item())
                for i, p in enumerate(base.jax_parameters()):
                    out[f"{key}/grad/{i}"] = p.grad.numpy().copy()
                out[key + "/W"] = np.int64(w or 0)
        _save(outdir, "halo", rank, **out)
    finally:
        shutdown()


# ------------------------------------------------------ collectives, shards


def collectives(rank, world, init, outdir):
    """ring_exchange and all_gather_rows with their gradients, and
    combine_eval_results, against what the definitions give."""
    from gnn_tumor_seg_tpu_torch.parallel.collectives import (
        all_gather_rows, all_reduce_sum, ring_exchange)
    from gnn_tumor_seg_tpu_torch.parallel.mesh import shutdown
    from gnn_tumor_seg_tpu_torch.parallel.multihost import combine_eval_results

    mesh = _mesh(rank, world, init)
    try:
        h = (torch.arange(12.0).reshape(6, 2) + 100 * rank).requires_grad_()
        left, right = ring_exchange(h, 2, mesh)
        (3 * left.sum() + 5 * right.sum()).backward()
        g = (torch.arange(8.0).reshape(4, 2) + 10 * rank).requires_grad_()
        full = all_gather_rows(g, mesh)
        (full * torch.arange(full.numel(), dtype=torch.float32)
         .reshape(full.shape)).sum().backward()
        s = all_reduce_sum(torch.tensor([float(rank + 1)]), mesh)
        metrics = np.arange(10.0) + rank
        counts = np.full(8, rank + 1.0)
        m, c, n = combine_eval_results(metrics, counts, rank + 1, mesh)
        _save(outdir, "coll", rank, left=left.detach().numpy(),
              right=right.detach().numpy(), h_grad=h.grad.numpy(),
              full=full.detach().numpy(), g_grad=g.grad.numpy(),
              sum=s.numpy(), metrics=m, counts=c, n=np.int64(n))
    finally:
        shutdown()


# ------------------------------------------------------------------- DP


def dp_epoch(rank, world, init, outdir, spec_json):
    """One exact ParallelGNNTrainer epoch on a synthetic set; the loss, the
    parameters, and each step's local loss terms."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
    from gnn_tumor_seg_tpu_torch.parallel import dp
    from gnn_tumor_seg_tpu_torch.parallel.mesh import shutdown
    from gnn_tumor_seg_tpu_torch.train.losses import weighted_nll_terms

    mesh = _mesh(rank, world, init)
    try:
        spec = json.loads(spec_json)
        data = SyntheticGraphDataset(**spec["data"])
        hp = HyperParams(**spec["hp"])
        tr = dp.ParallelGNNTrainer(spec["model_type"], hp, data, seed=0,
                                   mesh=mesh, precision="exact")
        local = []
        step = tr._step

        def recording_step(batch, generator):
            with torch.no_grad():
                wnll, w = weighted_nll_terms(tr.model(batch), batch.labels,
                                             tr.class_weights, batch.node_mask)
            local.append((float(wnll.sum()), float(w.sum())))
            return step(batch, generator)

        tr._step = recording_step
        loss = tr.run_epoch()
        _save(outdir, "dp", rank, loss=np.float64(loss),
              local=np.asarray(local),
              **{f"p/{i}": p.detach().numpy()
                 for i, p in enumerate(tr.model.jax_parameters())})
    finally:
        shutdown()


# ------------------------------------------------------------ halo trainer


def halo_training(rank, world, init, outdir, spec_path):
    """HaloTrainer epochs per (model, variant) case; rank 0's checkpoint,
    the own logits after training, and a resumed trainer's parameters."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.parallel import halo
    from gnn_tumor_seg_tpu_torch.parallel.halo_trainer import HaloTrainer
    from gnn_tumor_seg_tpu_torch.parallel.mesh import shutdown

    mesh = _mesh(rank, world, init)
    try:
        data = np.load(spec_path)
        spec = json.loads(str(data["training"]))
        args = (data["feats"], data["src"], data["dst"], data["tlabels"], world)
        out = {}
        for c in spec["cases"]:
            hp = HyperParams(in_feats=int(data["feats"].shape[1]),
                             layer_sizes=c["layers"], lr=spec["lr"],
                             gat_heads=c.get("heads"),
                             gat_residuals=c.get("residuals"))
            if c["variant"] == "p2p":
                pg, w = halo.partition_graph_p2p(*args)
            else:
                pg, w = halo.partition_graph(*args), None
            tr = HaloTrainer(c["model_type"], hp, [pg], mesh,
                             variant=c["variant"], halo_width=w, seed=0,
                             precision=spec["precision"])
            losses = [tr.run_epoch() for _ in range(spec["epochs"])]
            name = f"{c['model_type']}_{c['variant']}"
            tr.save_weights(outdir + os.sep, name)
            resumed = HaloTrainer(c["model_type"], hp, [pg], mesh,
                                  variant=c["variant"], halo_width=w, seed=1,
                                  resume_from=os.path.join(outdir,
                                                           name + ".ckpt"))
            same = all(torch.equal(a, b) for a, b in zip(
                tr.model.jax_parameters(), resumed.model.jax_parameters()))
            out[name + "/losses"] = np.asarray(losses)
            out[name + "/logits"] = tr.own_logits(tr.graphs[0]).numpy()
            out[name + "/resumed_equal"] = np.bool_(same and
                                                    resumed.epoch == tr.epoch)
        _save(outdir, "train", rank, **out)
    finally:
        shutdown()


# ------------------------------------------------------- tensor parallelism


def _whole(tr, tensors):
    """The rank's parts of every parameter (or gradient) of a
    ParallelGNNTrainer, gathered whole over the model group."""
    from gnn_tumor_seg_tpu_torch.parallel.collectives import gather_leaf

    axes = tr._tp_axes or [None] * len(tensors)
    return [(t if ax is None else gather_leaf(t, ax, tr.mesh)).numpy().copy()
            for t, ax in zip(tensors, axes)]


def _tp_trainer(name, hp, data, mesh, leaves):
    """An "exact" ParallelGNNTrainer from the JAX model's whole leaves."""
    from gnn_tumor_seg_tpu_torch.parallel import dp

    tr = dp.ParallelGNNTrainer(name, hp, data, seed=0, mesh=mesh,
                               precision="exact")
    it = iter(leaves)
    tr.load_params([{k: next(it) for k in layer.keys}
                    for layer in tr.model.layers])
    return tr


def _tp_step_and_epoch(tr, data, name):
    """The first global batch's loss and summed gradients (loss_and_grads,
    gathered whole, dropout drawn as run_epoch draws it), then one epoch's
    loss and whole parameters."""
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    out = {}
    order = np.random.default_rng((0, 0)).permutation(len(data))
    idx, _, _ = next(tr._epoch_batches(order))
    n_pad, d_pad = tr._shape_budget
    batch = batch_graphs([data.get_graph(int(i)) for i in idx],
                         n_pad=n_pad, d_pad=d_pad)
    generator = torch.Generator().manual_seed(tr._dropout_seed())
    with precision_scope("exact"):
        out[name + "/step_loss"] = np.float64(tr.loss_and_grads(batch, generator))
    for i, g in enumerate(_whole(tr, [p.grad for p in tr.model.jax_parameters()])):
        out[f"{name}/grad/{i}"] = g
    tr.optimizer.zero_grad(set_to_none=True)
    out[name + "/loss"] = np.float64(tr.run_epoch())
    for i, p in enumerate(_whole(tr, [p.detach() for p in
                                      tr.model.jax_parameters()])):
        out[f"{name}/param/{i}"] = p
    return out


def tp_world(rank, world, init, n_model, outdir, spec_path):
    """A (world // n_model, n_model) mesh: the mesh's axes and groups, the
    model-group collectives with their gradients, and per case of the spec,
    from the given whole parameters in "exact": the first global batch's
    loss and summed gradients (loss_and_grads, gathered whole), one epoch's
    loss and whole parameters, a checkpoint and a trainer resumed from it;
    then a "fast" GSpool run's losses."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
    from gnn_tumor_seg_tpu_torch.parallel import dp
    from gnn_tumor_seg_tpu_torch.parallel.collectives import (
        all_reduce_sum, copy_to_model, gather_from_model)
    from gnn_tumor_seg_tpu_torch.parallel.mesh import initialize_multihost, shutdown

    torch.set_num_threads(1)
    mesh = initialize_multihost(init, world, rank, device="cpu",
                                n_model=n_model, timeout_s=GROUP_TIMEOUT_S)
    try:
        spec = np.load(spec_path)
        cfg = json.loads(str(spec["config"]))
        out = {"axes": np.asarray([mesh.data_rank, mesh.model_rank,
                                   mesh.n_data, mesh.n_model])}
        # the groups: sums over each axis, and the model-group Functions
        out["data_sum"] = all_reduce_sum(torch.tensor([float(rank)]),
                                         mesh.along("data")).numpy()
        out["model_sum"] = all_reduce_sum(torch.tensor([float(rank)]),
                                          mesh.along("model")).numpy()
        x = (torch.arange(6.0).reshape(2, 3) + 10 * rank).requires_grad_()
        full = gather_from_model(x, mesh)
        w = torch.arange(12.0).reshape(2, 6)
        (full * w).sum().backward()
        out["gathered"] = full.detach().numpy()
        out["gather_grad"] = x.grad.numpy()
        z = torch.full((2, 6), float(rank + 1), requires_grad=True)
        (copy_to_model(z, mesh) * w).sum().backward()
        out["copy_grad"] = z.grad.numpy()

        data = SyntheticGraphDataset(**cfg["data"])
        for c in cfg["cases"]:
            name = c["model_type"]
            hp = HyperParams(**cfg["hp"], **c["hp"])
            leaves = [spec[f"{name}/{i}"] for i in range(c["n_leaves"])]
            tr = _tp_trainer(name, hp, data, mesh, leaves)
            out.update(_tp_step_and_epoch(tr, data, name))
            params = [out[f"{name}/param/{i}"] for i in range(len(leaves))]
            tr.save_weights(outdir + os.sep, name)
            resumed = dp.ParallelGNNTrainer(name, hp, data, seed=1, mesh=mesh,
                                            precision="exact")
            resumed.restore(os.path.join(outdir, name + ".ckpt"))
            again = _whole(resumed, [p.detach() for p in
                                     resumed.model.jax_parameters()])
            out[name + "/resumed_equal"] = np.bool_(
                resumed.epoch == tr.epoch
                and all(np.array_equal(a, b) for a, b in zip(params, again)))
        hp = HyperParams(**{**cfg["hp"], "lr": 3e-3}, layer_sizes=[16, 16])
        fast = dp.ParallelGNNTrainer("GSpool", hp, data, seed=0, mesh=mesh,
                                     precision="fast")
        out["fast_losses"] = np.asarray([fast.run_epoch() for _ in range(4)])
        _save(outdir, "tp", rank, **out)
    finally:
        shutdown()


def tp_dropout_world(rank, world, init, n_model, outdir, spec_path, drop):
    """A (world // n_model, n_model) mesh training the spec's GSpool and GAT
    cases with feature dropout `drop` (and attention dropout `drop` on the
    GAT): the first global batch's loss and summed gradients and one epoch's
    loss and whole parameters, as tp_world records them."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.data.synthetic import SyntheticGraphDataset
    from gnn_tumor_seg_tpu_torch.parallel.mesh import initialize_multihost, shutdown

    torch.set_num_threads(1)
    mesh = initialize_multihost(init, world, rank, device="cpu",
                                n_model=n_model, timeout_s=GROUP_TIMEOUT_S)
    try:
        spec = np.load(spec_path)
        cfg = json.loads(str(spec["config"]))
        data = SyntheticGraphDataset(**cfg["data"])
        out = {}
        for c in cfg["cases"]:
            name = c["model_type"]
            if name not in ("GSpool", "GAT"):
                continue
            hp = HyperParams(**cfg["hp"], **c["hp"], feature_dropout=drop)
            tr = _tp_trainer(name, hp, data, mesh,
                             [spec[f"{name}/{i}"] for i in range(c["n_leaves"])])
            if name == "GAT":
                tr.model.attn_drop = drop
            out.update(_tp_step_and_epoch(tr, data, name))
        _save(outdir, "drop", rank, **out)
    finally:
        shutdown()
