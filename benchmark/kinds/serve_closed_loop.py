"""Kind `serve_closed_loop`: one client sends single-MRI requests back to
back to the serve entry point, `cli.predict_single.predict_single_mri`,
NIfTI read to BraTS label volume, as the CLI calls it.

Set-up draws `brains` synthetic brains and the configuration's weights
from the seed, writes the brains as .nii.gz under the run's scratch
directory and the weights as the program's checkpoints, loads them as the
CLI does, and serves one request. The brains share one extent, so that
request builds and loads everything the window uses: the CNN's crop may
differ from brain to brain, and serving runs cuDNN without autotuning,
so a new crop shape costs nothing a warm request would save. The window
serves the brains in turn until `seconds` have passed; every request
started in it completes and counts.

Benchmark spans wrap the program's layers (its module functions, patched
for the run; none of the program's files changes) and, for a sample of
the window's requests drawn from the seed, keep what each stage produced
for the reference's judgement after the window.

Traffic parameters: brains, num_nodes, k, boxiness, prep_impl,
slic_impl, precision, crop_floor, check_requests, trace_requests.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from .. import inputs, models, weights
from ..reference import serve as ref


class _Spans:
    """Patches the program's layer functions with wrappers that open a
    span around each call and, while `keep` is a dict, store the call's
    outputs in it."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.keep: dict | None = None
        self.counts: dict = {}
        self._undo = []

    def wrap(self, module, attr, span, store=None):
        orig = getattr(module, attr)
        spans = self

        def wrapper(*args, **kwargs):
            with spans.tracer.span(span) if spans.tracer.enabled else contextlib.nullcontext():
                out = orig(*args, **kwargs)
            if store is not None:
                store(spans, args, kwargs, out)
            return out

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


def _keep(spans, **items):
    if spans.keep is not None:
        spans.keep.update(items)


def _store_device_prep(spans, args, kwargs, out):
    _keep(spans, cells=out[0], std=out[1])


def _store_std(spans, args, kwargs, out):
    _keep(spans, std=out)


def _store_cells(spans, args, kwargs, out):
    _keep(spans, cells=out)


def _store_sample(spans, args, kwargs, out):
    spans.counts["n_edges"] = len(out.src)
    _keep(spans, partition=args[2], feats=out.feats, src=out.src, dst=out.dst)


def _install(spans):
    from gnn_tumor_seg_tpu_torch.cli import common as cc
    from gnn_tumor_seg_tpu_torch.cli import predict_single as ps
    from gnn_tumor_seg_tpu_torch.data import graph_build as gb
    from gnn_tumor_seg_tpu_torch.data import native as nat
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.ops import slic_device as sd

    spans.wrap(nifti, "read_in_patient_sample", "serve.nifti_read")
    spans.wrap(ps, "determine_brain_crop", "serve.brain_crop")
    spans.wrap(ps, "normalize_img", "serve.normalize")
    spans.wrap(ps, "standardize_img", "serve.standardize", _store_std)
    spans.wrap(sd, "serve_preprocess_device", "serve.slic_device", _store_device_prep)
    spans.wrap(sd, "finalize_labels", "serve.connectivity")
    spans.wrap(nat, "slic3d_native", "serve.slic_host", _store_cells)
    spans.wrap(nat, "enforce_connectivity_native", "serve.connectivity")
    spans.wrap(ps, "build_graph_sample", "serve.graph_build")
    spans.wrap(ps, "sample_from_partition", "serve.stats_knn", _store_sample)
    spans.wrap(gb, "sample_from_partition", "serve.stats_knn", _store_sample)
    spans.wrap(ps, "graph_from_arrays", "serve.ell_table")
    spans.wrap(ps, "predict_one_sample_device", "serve.joint")
    spans.wrap(ps, "predict_one_sample", "serve.joint")
    spans.wrap(cc, "ship_partition", "serve.ship_partition")


def make_inputs(run) -> dict:
    """The weights of the GNN and the CNN and the raw brains [C, X, Y, Z]
    (int16, on the host), from the seed."""
    cfg, dev = run.cell.config, run.device
    cnn = cfg["cnn"]
    specs = weights.model_specs(cfg)
    cnn_specs = weights.cnn_specs(cnn["in_feats"], cnn["layer_sizes"][0],
                                  cnn["out_classes"], cnn["kernel"])
    gen = inputs.seed_generator(run.seed, dev, 3)
    shape = tuple(run.param("brain_shape"))
    return {"specs": specs, "cnn_specs": cnn_specs,
            "weights": weights.draw(specs, inputs.seed_generator(run.seed, dev, 1)),
            "cnn_weights": weights.draw(cnn_specs, inputs.seed_generator(run.seed, dev, 2)),
            "brains": [inputs.make_brain(gen, shape)[0].cpu().numpy()
                       for _ in range(run.param("brains"))]}


def setup(run):
    from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                    load_gnn_from_checkpoint,
                                                    resolve_slic_fn)
    from gnn_tumor_seg_tpu_torch.cli.predict_single import predict_single_mri
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
    from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet
    from gnn_tumor_seg_tpu_torch.ops.precision import set_precision_mode
    from gnn_tumor_seg_tpu_torch.train.checkpoint import save_checkpoint

    cfg, dev = run.cell.config, run.device
    run.mark("imports")
    set_precision_mode(run.param("precision"))
    made = make_inputs(run)
    run.mark("inputs")
    w, cw, brains = made["weights"], made["cnn_weights"], made["brains"]
    cnn = cfg["cnn"]
    hp = models.hyperparams(HyperParams, cfg)
    model = init_graph_net(cfg["model"], hp)
    weights.load_into(model.jax_parameters(), w, made["specs"])
    gnn_ckpt = os.path.join(run.scratch, "gnn.ckpt")
    save_checkpoint(gnn_ckpt, model, cfg["model"], hp)
    net = CnnRefinementNet(cnn["in_feats"], cnn["out_classes"], cnn["layer_sizes"])
    weights.load_into(net.jax_parameters(), cw, made["cnn_specs"])
    cnn_ckpt = os.path.join(run.scratch, "cnn.ckpt")
    save_checkpoint(cnn_ckpt, net, "CNN",
                    HyperParams(in_feats=cnn["in_feats"],
                                out_classes=cnn["out_classes"],
                                layer_sizes=list(cnn["layer_sizes"])))
    _, _, gnn_fwd = load_gnn_from_checkpoint(gnn_ckpt, device=dev)
    _, _, cnn_fwd = load_cnn_from_checkpoint(cnn_ckpt, device=dev)
    run.mark("checkpoints")
    dirs = [inputs.write_brain_dir(raw, os.path.join(run.scratch, f"brain{b}"))
            for b, raw in enumerate(brains)]
    run.mark("nifti")

    spans = _Spans(run.tracer)
    _install(spans)

    def gnn_forward(graph):
        with run.tracer.span("serve.gnn") if run.tracer.enabled else contextlib.nullcontext():
            out = gnn_fwd(graph)
        spans.counts["n_nodes"] = int(graph.n_nodes[0])
        _keep(spans, node_logits=out[0])
        return out

    def cnn_forward(x):
        with run.tracer.span("serve.cnn") if run.tracer.enabled else contextlib.nullcontext():
            out = cnn_fwd(x)
        spans.counts["cnn_voxels"] = int(np.prod(x.shape[1:4]))
        _keep(spans, cnn_x=x[0], cnn_logits=out[0])
        return out

    slic_fn = resolve_slic_fn(run.param("slic_impl"), device=dev)

    def request(b, stage_times=None):
        return predict_single_mri(
            dirs[b], gnn_forward, cnn_forward, num_nodes=run.param("num_nodes"),
            num_neighbors=run.param("k"), boxiness=run.param("boxiness"),
            slic_fn=slic_fn, stage_times=stage_times,
            prep_impl=run.param("prep_impl"), device=dev)

    request(0)
    run.mark("warm request")
    # the judged requests: distinct brains, each in one of the first two rounds
    rng = np.random.default_rng([run.seed % 2**63, 4])
    n_check = min(run.param("check_requests"), len(brains))
    sample = {int(r) * len(brains) + int(b) for b, r in zip(
        rng.choice(len(brains), size=n_check, replace=False),
        rng.integers(0, 2, size=n_check))}
    return {"brains": brains, "request": request, "spans": spans,
            "sample": sample, "kept": {}, "weights": w, "cnn_weights": cw}


def window(state, run) -> dict:
    spans, requests = state["spans"], []
    attempted = failed = 0
    n_brains = len(state["brains"])
    traced = run.param("trace_requests") if run.trace else 0
    last = None
    # the first `traced` requests run as one profiled region
    region = contextlib.ExitStack()
    if traced:
        region.enter_context(run.tracer.region())
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        j = attempted
        b = j % n_brains
        spans.keep = {"brain": b}
        st = {} if run.trace else None
        attempted += 1
        t = time.perf_counter()
        try:
            with run.tracer.span("serve.request") if run.trace else contextlib.nullcontext():
                labels = state["request"](b, st)
        except Exception as exc:          # a failed request counts and the loop goes on
            failed += 1
            print(f"request {j} failed: {exc!r}", flush=True)
            labels = None
        wall = time.perf_counter() - t
        if j == traced - 1:
            region.close()
        if labels is None:
            continue
        spans.keep["labels"] = labels
        if j in state["sample"]:
            state["kept"][j] = spans.keep
        last = (j, spans.keep)
        spans.keep = None
        requests.append({"wall": wall, "stages": st, "traced": j < traced,
                         **spans.counts})
    region.close()
    # where the window ended before any sampled request, its last is judged
    if not state["kept"] and last is not None:
        state["kept"][last[0]] = last[1]
    spans.restore()
    print("request walls " + " ".join(f"{r['wall']:.4f}" for r in requests),
          file=sys.stderr)
    total = sum(r["wall"] for r in requests)
    return {"attempted": attempted, "failed": failed,
            "e2e": {"s_per_mri": total / max(len(requests), 1)},
            "record": {"kind": "serve", "requests": requests,
                       "precision": run.param("precision"),
                       "config": run.cell.config}}


def _record(kept: dict, device) -> dict:
    """A kept request as the reference's record: the standardized volume
    as [C, X, Y, Z] on the device."""
    rec = dict(kept)
    std = rec["std"]
    if isinstance(std, np.ndarray):            # the host path's [X, Y, Z, C]
        std = torch.from_numpy(np.ascontiguousarray(np.moveaxis(std, -1, 0)))
    rec["std"] = std.to(device)
    return rec


def judge(state, run) -> dict:
    cfg, params = run.cell.config, _params(run)
    kept = state.pop("kept")
    state.pop("request")
    if not kept:
        return {}
    worst: dict = {}
    for j in sorted(kept):
        rec = _record(kept[j], run.device)
        numbers = ref.judge(rec, state["brains"][rec["brain"]], cfg, state["weights"],
                            state["cnn_weights"], params, run.device)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del rec
    return worst


def _params(run) -> dict:
    return {"num_nodes": run.param("num_nodes"), "boxiness": run.param("boxiness"),
            "k": run.param("k"), "crop_floor": tuple(run.param("crop_floor"))}


def control(run, prec) -> dict:
    """The reference in `prec` put in the program's place, on the seed's
    first brain, judged as a request would be."""
    cfg, made = run.cell.config, make_inputs(run)
    raw = made["brains"][0]
    rec = ref.control_record(raw, cfg, made["weights"], made["cnn_weights"],
                             _params(run), prec, run.device)
    return ref.judge(rec, raw, cfg, made["weights"], made["cnn_weights"],
                     _params(run), run.device)
