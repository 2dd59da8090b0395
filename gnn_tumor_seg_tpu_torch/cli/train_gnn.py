"""CLI: train a GNN on preprocessed supervoxel graphs (k-fold or full dataset)
on one device (counterpart of gnn_tumor_seg_tpu/cli/train_gnn.py).

Argument contract of `scripts/train_gnn.py:64-89` and of the JAX package's
CLI, single-device regime; k=1 trains on the full dataset. Checkpoints
(`<run>_f<fold>.ckpt`, with optimizer state) and the progress TSV
(`<run>.txt`, plus a JSON-lines log `<run>.txt.jsonl`) land in the output
directory, in the JAX package's formats.

  python -m gnn_tumor_seg_tpu_torch.cli.train_gnn -d <processed> -o <logs> -r run1 \\
      [-m GSpool|GSmean|GSgcn|GAT] [-k K] [-x] [--hp KEY=VAL ...] \\
      [--resume_from CKPT] [--profile DIR] [--device cuda|cpu]

Runs on the GPU unless --device cpu is given (then every aggregation and
GAT's fused attention take their plain PyTorch versions). Training runs in
precision mode "fast" unless GTS_PALLAS_PRECISION=exact, as for the JAX
package. --impl has no counterpart: the port has one aggregation per
device, the kernels on CUDA and their plain versions on the CPU.

Distributed training, one process per rank over torch.distributed
(parallel/):

  --parallel dp   --mesh D[,M] data-parallel minibatch training
                              (parallel/dp.py): each data index takes its
                              slice of every global batch; the loss is the
                              global weighted mean and the gradients are
                              summed. With M > 1 each layer also runs
                              tensor-parallel over M model ranks (its
                              weights' output columns, or a GAT layer's
                              heads, split over them); D * M ranks in all.
  --parallel halo --mesh D    node-partitioned giant-graph training
                              (parallel/halo*.py): each step's minibatch is
                              one disjoint-union graph split over the ranks;
                              --halo_variant p2p exchanges only boundary
                              rows (all_gather when the edges are not
                              local, which it prints), all_gather works for
                              any edge structure.

Without --coordinator the command starts the D * M ranks itself
(torch.multiprocessing.spawn; one rank runs in this process), on
cuda:(rank % visible cards), or on the CPU with --device cpu. With
--coordinator HOST:PORT --num_processes P --process_id R it is one rank of
P, started once per rank. NCCL serves ranks that each have a card; gloo
serves the CPU and ranks that share a card. Rank 0 alone writes
checkpoints and progress files, and the command exits non-zero if any rank
fails. --parallel halo takes --mesh D only, as the JAX CLI. --mesh defaults
to every visible card on the data axis (1 on the CPU).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..config import hardcoded_hyperparameters, random_hyperparameters
from ..data.dataset import ImageGraphDataset
from ..runtime import resolve_device
from ..train import folds
from ..train.gnn_trainer import GNNTrainer

__all__ = ["main", "build_parser", "apply_hp_overrides", "document_metrics"]

_MULTI_PROCESS_OPTIONS = ("coordinator", "num_processes", "process_id")


class _SubsetView:
    """A view of a dataset restricted to given indices (a fold's training
    set). Shares the underlying cache and exposes the data protocol the
    trainer expects."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)
        self.ids = [base.ids[i] for i in self.indices]

    def __len__(self):
        return len(self.indices)

    def get_graph(self, i):
        return self.base.get_graph(self.indices[i])

    def get_sample(self, i):
        return self.base.get_sample(self.indices[i])

    def get_supervoxel_partitioning(self, mri_id):
        return self.base.get_supervoxel_partitioning(mri_id)

    def get_voxel_labels(self, mri_id):
        return self.base.get_voxel_labels(mri_id)

    def shape_budget(self):
        return self.base.shape_budget()


def apply_hp_overrides(hp, overrides):
    """Apply --hp KEY=VAL overrides (Python-literal values) to a HyperParams."""
    known = {f.name for f in dataclasses.fields(type(hp))}
    for item in overrides:
        key, _, val = item.partition("=")
        key = key.strip()
        if key not in known:
            raise SystemExit(f"--hp: unknown HyperParams field {key!r} "
                             f"(known: {sorted(known)})")
        try:
            parsed = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            parsed = val
        hp = dataclasses.replace(hp, **{key: parsed})
    return hp


def document_metrics(fp: str, description: str, results,
                     coordinator: bool = True) -> None:
    """Pretty-print + progress-file row (`scripts/train_gnn.py:48-59`); only
    the coordinator writes the row."""
    metrics, counts = np.around(results[0], 4), results[1]
    print(f"\n#{description} Results#")
    print("Loss:", metrics[0])
    print("Predicted Node Counts:", counts[0:4])
    print("Label Node Counts:", counts[4:8])
    print(f"WT Node Dice: {metrics[1]}, CT Node Dice: {metrics[2]}, ET Node Dice: {metrics[3]}")
    print(f"WT Voxel Dice: {metrics[4]}, CT Voxel Dice: {metrics[5]}, ET Voxel Dice: {metrics[6]}")
    print(f"WT HD95: {metrics[7]}, CT HD95: {metrics[8]}, ET HD95: {metrics[9]}")
    if coordinator:
        folds.update_progress_file(fp, description, metrics[0], metrics[4:7])


# ---------------------------------------------------------------------------
# minibatch regimes: one device, or data-parallel over the mesh
# ---------------------------------------------------------------------------


def _make_trainer(args, hp, train_view, mesh):
    if mesh is not None:
        from ..parallel.dp import ParallelGNNTrainer

        return ParallelGNNTrainer(args.model_type, hp, train_view, mesh=mesh)
    return GNNTrainer(args.model_type, hp, train_view, device=args.device)


def _evaluate(model, dataset, indices, mesh):
    """Evaluate `indices`: on one device all of them; data-parallel, each
    data index its shard (every model rank of it the same, since the
    forward is collective), combined over the data group, so each data
    index counts once."""
    if mesh is None:
        return model.evaluate(dataset, indices)
    from ..parallel.multihost import combine_eval_results, process_shard

    data = mesh.along("data")
    local = process_shard(indices, data.rank, data.world_size)
    metrics, counts = model.evaluate(dataset, local)
    metrics, counts, _ = combine_eval_results(metrics, counts, len(local), data)
    return metrics, counts


def _log_fp(progress_fp, mesh):
    return progress_fp + ".jsonl" if mesh is None or mesh.is_coordinator else None


def train_on_full_dataset(args, hp, progress_fp, dataset, mesh=None):
    print("Training on full dataset")
    all_idx = list(range(len(dataset)))
    model = _make_trainer(args, hp, _SubsetView(dataset, all_idx), mesh)
    if args.resume_from:
        print(f"Resuming from {args.resume_from}")
        model.restore(os.path.expanduser(args.resume_from))
    folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                        args.run_name, 1, log_fp=_log_fp(progress_fp, mesh))
    document_metrics(progress_fp, f"{args.run_name}_full",
                     _evaluate(model, dataset, all_idx, mesh),
                     coordinator=mesh is None or mesh.is_coordinator)


def run_k_fold_val(args, hp, progress_fp, dataset, k, mesh=None):
    coordinator = mesh is None or mesh.is_coordinator
    for fold_idx, (s, e) in enumerate(folds.chunk_dataset_into_folds(len(dataset), k)):
        val_idx = list(range(s, e))
        train_idx = list(range(0, s)) + list(range(e, len(dataset)))
        train_view = _SubsetView(dataset, train_idx)
        print(f"Fold contains {len(train_view)} examples")
        model = _make_trainer(args, hp, train_view, mesh)
        fold = fold_idx + 1
        folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                            args.run_name, fold,
                            log_fp=_log_fp(progress_fp, mesh))
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_train",
                         _evaluate(model, dataset, train_idx, mesh),
                         coordinator=coordinator)
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_val",
                         _evaluate(model, dataset, val_idx, mesh),
                         coordinator=coordinator)


# ---------------------------------------------------------------------------
# halo regime: node-partitioned giant unions
# ---------------------------------------------------------------------------


def _run_halo(args, hp, progress_fp, dataset, mesh):
    """Every rank builds the same unions (the graph is partitioned by node
    range, not by sample), trains with the fold and early-stop contract, and
    evaluates with the reference's 10-metric vector (JAX cli/train_gnn.py:185)."""
    from ..parallel.halo_data import build_partitioned_sets
    from ..parallel.halo_trainer import HaloTrainer

    n_parts = mesh.world_size
    gpb = args.graphs_per_batch or hp.batch_size
    k = args.num_folds
    coordinator = mesh.is_coordinator

    def make_trainer(train_batches, variant, w):
        resume = (os.path.expanduser(args.resume_from)
                  if args.resume_from and k == 1 else None)
        return HaloTrainer(args.model_type, hp, [b.pg for b in train_batches],
                           mesh, variant=variant, halo_width=w,
                           resume_from=resume)

    if k == 1:
        all_idx = list(range(len(dataset)))
        (batches,), variant, w = build_partitioned_sets(
            dataset, n_parts, gpb, args.halo_variant, [all_idx])
        print(f"halo: {len(batches)} union graph(s) of <= {gpb} samples, "
              f"{n_parts} shards, variant={variant}"
              + (f", W={w}" if w else ""))
        model = make_trainer(batches, variant, w)
        folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                            args.run_name, 1, log_fp=_log_fp(progress_fp, mesh))
        document_metrics(progress_fp, f"{args.run_name}_full",
                         model.evaluate(batches, dataset),
                         coordinator=coordinator)
        return

    for fold_idx, (s, e) in enumerate(
            folds.chunk_dataset_into_folds(len(dataset), k)):
        val_idx = list(range(s, e))
        train_idx = list(range(0, s)) + list(range(e, len(dataset)))
        (train_b, val_b), variant, w = build_partitioned_sets(
            dataset, n_parts, gpb, args.halo_variant, [train_idx, val_idx])
        print(f"Fold contains {len(train_idx)} examples "
              f"({len(train_b)} unions, variant={variant})")
        model = make_trainer(train_b, variant, w)
        fold = fold_idx + 1
        # select and early-stop on the partitioned validation loss
        folds.train_on_fold(model, args.output_dir + os.sep, hp.n_epochs,
                            args.run_name, fold,
                            log_fp=_log_fp(progress_fp, mesh),
                            val_loss_fn=lambda: model.evaluate_loss(val_b))
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_train",
                         model.evaluate(train_b, dataset),
                         coordinator=coordinator)
        document_metrics(progress_fp, f"{args.run_name}_f{fold}_val",
                         model.evaluate(val_b, dataset),
                         coordinator=coordinator)


# ---------------------------------------------------------------------------


def _parse_mesh(spec: str | None) -> tuple[int | None, int]:
    """'D[,M]' -> (D, M); (None, 1) when not given."""
    if not spec:
        return None, 1
    parts = [int(x) for x in spec.split(",")]
    if len(parts) > 2 or min(parts) < 1:
        raise ValueError(f"--mesh takes D or D,M with positive sizes, got {spec!r}")
    return parts[0], (parts[1] if len(parts) > 1 else 1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--data_dir", required=True, type=str)
    p.add_argument("-o", "--output_dir", required=True, type=str,
                   help="Log directory (weights + progress file)")
    p.add_argument("-r", "--run_name", required=True, type=str)
    p.add_argument("-m", "--model_type", default="GSpool", type=str,
                   help="GSpool, GSmean, GSgcn or GAT")
    p.add_argument("-k", "--num_folds", default=5, type=int,
                   help="k-fold validation folds; 1 = train on full dataset")
    p.add_argument("-p", "--data_prefix", default="", type=str)
    p.add_argument("-x", "--random_hyperparams", action="store_true")
    p.add_argument("--hp", action="append", default=[], metavar="KEY=VAL",
                   help="override a HyperParams field, e.g. --hp n_epochs=3 "
                        "--hp 'layer_sizes=[64,64]' (values are Python "
                        "literals; repeatable)")
    p.add_argument("--profile", default=None, type=str, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(a Chrome trace, for chrome://tracing or Perfetto)")
    p.add_argument("--resume_from", default=None, type=str,
                   help="checkpoint to resume training from (params + optimizer "
                        "state + epoch; full-dataset runs, -k 1)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without a GPU) or cpu")
    # ---- distribution (parallel/) ----
    p.add_argument("--parallel", default="single",
                   choices=["single", "dp", "halo"],
                   help="single: one device; dp: the minibatch split over the "
                        "ranks; halo: one union graph a step, its nodes split "
                        "over the ranks")
    p.add_argument("--mesh", default=None, type=str, metavar="D[,M]",
                   help="D ranks on the data axis, M on the model axis "
                        "(tensor parallelism, --parallel dp only); "
                        "default: every visible card on the data axis")
    p.add_argument("--halo_variant", default="p2p",
                   choices=["p2p", "all_gather"],
                   help="halo exchange: p2p = boundary rows only (all_gather "
                        "when the edges are not local), all_gather = every row")
    p.add_argument("--graphs_per_batch", default=None, type=int,
                   help="halo: samples per union graph (default: batch_size)")
    # ---- one rank per process ----
    p.add_argument("--coordinator", default=None, type=str, metavar="HOST:PORT",
                   help="the TCP address rank 0 listens on")
    p.add_argument("--num_processes", default=None, type=int,
                   help="world size (start this command once per rank)")
    p.add_argument("--process_id", default=None, type=int,
                   help="this process's rank")
    return p


def _load_and_run(args, mesh) -> None:
    """Read the data and hyperparameters and train: on one device (mesh
    None) or as the mesh's rank."""
    from ..parallel.mesh import rank_device

    dataset = ImageGraphDataset(os.path.expanduser(args.data_dir),
                                args.data_prefix, read_image=False,
                                read_graph=True, read_label=True)
    hp = (random_hyperparameters(args.model_type) if args.random_hyperparams
          else hardcoded_hyperparameters(args.model_type))
    hp = apply_hp_overrides(hp, args.hp)
    coordinator = True
    if mesh is not None:
        import torch.distributed as dist

        box = [hp]                        # one draw of -x for every rank
        dist.broadcast_object_list(box, src=0)
        hp = box[0]
        coordinator = mesh.is_coordinator
        args.device = rank_device(mesh.rank, args.device)
    args.output_dir = os.path.expanduser(args.output_dir)
    progress_fp = os.path.join(args.output_dir, f"{args.run_name}.txt")
    if coordinator:
        folds.create_run_progress_file(progress_fp, args.model_type, hp)
    profiler = contextlib.nullcontext()
    if args.profile and coordinator:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if args.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                os.path.expanduser(args.profile)))
    with profiler:
        if args.parallel == "halo":
            _run_halo(args, hp, progress_fp, dataset, mesh)
        elif args.num_folds == 1:
            train_on_full_dataset(args, hp, progress_fp, dataset, mesh)
        else:
            run_k_fold_val(args, hp, progress_fp, dataset, args.num_folds, mesh)


def _run_rank(rank: int, world: int, init_method: str, args,
              n_model: int = 1) -> None:
    """One rank: join the process group, train, leave the group."""
    from ..parallel.mesh import initialize_multihost, shutdown

    if args.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = initialize_multihost(init_method, world, rank, device=args.device,
                                n_model=n_model)
    try:
        _load_and_run(args, mesh)
    finally:
        shutdown()


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.num_folds < 1:
        parser.error("Number of folds must be a positive integer")
    if args.resume_from and args.num_folds != 1:
        parser.error("--resume_from applies to full-dataset runs (-k 1)")
    try:
        n_data, n_model = _parse_mesh(args.mesh)
    except ValueError as e:
        parser.error(str(e))
    if args.parallel == "halo" and n_model != 1:
        parser.error("--parallel halo partitions nodes over the data axis "
                     "only; use --mesh D (n_model=1)")
    multi = [n for n in _MULTI_PROCESS_OPTIONS if getattr(args, n) is not None]
    if args.parallel == "single":
        if multi or args.mesh:
            parser.error("--mesh and the multi-process options need "
                         "--parallel dp or halo")
        args.device = resolve_device(args.device)
        _load_and_run(args, None)
        return
    args.device = resolve_device(args.device)
    if multi:
        if len(multi) != len(_MULTI_PROCESS_OPTIONS):
            parser.error("--coordinator, --num_processes and --process_id go "
                         "together")
        if n_data is not None and n_data * n_model != args.num_processes:
            parser.error(f"--mesh {args.mesh} does not match --num_processes "
                         f"{args.num_processes}")
        _run_rank(args.process_id, args.num_processes,
                  f"tcp://{args.coordinator}", args, n_model)
        return
    from ..parallel.mesh import free_port

    if n_data is None:
        n_data = torch.cuda.device_count() if args.device.type == "cuda" else 1
    world = n_data * n_model
    init = f"tcp://localhost:{free_port()}"
    if world == 1:
        _run_rank(0, 1, init, args)
    else:
        import torch.multiprocessing as mp

        mp.spawn(_run_rank, args=(world, init, args, n_model), nprocs=world,
                 join=True)


if __name__ == "__main__":
    main()
