#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gnn_tumor_seg_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases; the first failure ends the run with a non-zero exit and no result:

1. environment: torch, CUDA, triton, nvcc, and the card's name and power limit;
2. build: the CUDA kernels max_agg.cu (max aggregation and its backward),
   sum_agg.cu, fused_gat.cu (GAT's fused attention, its backward and the
   reverse combine), weighted_sum.cu (the weighted combine, its reverse and
   the pair dot) and slot_gather.cu (the per-slot gather and its backward)
   (nvcc, sm_90a) and the native host library (g++), all from the sources in
   this checkout, one compiler process each, in parallel; ptxas' registers
   and spills of sum_agg_kernel, max_agg_kernel, wsum_kernel,
   gat_fwd_kernel, gat_bwd_kernel, gat_rev_kernel, pairdot_kernel and
   slot_gather_bwd_kernel are logged, and a spill fails the run;
3. kernel check: max_agg against its plain PyTorch version on the card at
   random tables of the node bucket 8192 (B=1, D=12/16, F=20/256, f32 and
   bf16, with and without the winner-slot store) and at edge cases; then,
   at the training shapes (B=6, N=8192, D=12/16, F=3/20/36/256, f32 and
   bf16, and at D=12 F=5/10/64/128, the pool widths of a GSpool layer's
   column block under tensor parallelism) on random symmetric tables with
   ties and rows without a neighbour,
   max_agg with its store and as the serve variant (whose out must equal
   the store variant's), max_agg_bwd and sum_agg (sum and mean), also at
   D=12 on a table with holes, with h and gout one element off alignment
   (F=20, 256), at D=128 (F=6, 256) and F=515. Every result must be bitwise
   equal to the plain version's, and two runs of max_agg_bwd and of sum_agg
   bitwise equal to each other. Then the three GAT kernels at the
   training shapes ((H,F) = (4,256), (3,256), (1,4), at D=12 the
   head-parallel layers' (2,256) and (1,256) of phase 10, and (2,36), (3,6),
   (1,515) for
   every vector width of the reverse combine; tied logits,
   isolated rows, residual and ELU on and off; f32 and bf16) and at D=128,
   H=6, F=2, each table also with holes (real slots after padded ones) for
   the forward and the backward, and z/gout one element off alignment at
   (4,256): the forward within GAT_FWD_TOL of its plain version (bf16
   output: one ulp beyond it), its sign mask, serve variant and a second
   run bitwise, the backward within GAT_BWD_TOL, the reverse combine
   bitwise, every kernel deterministic. Then the
   decomposed kernels at the training shapes, with weights that are not
   symmetric and nonzero on padded slots: wsum and wsum_bwd at (H,F) =
   (1,20), (1,256), (4,256), (3,256), (1,4) and, for every vector width,
   (1,3), (2,6), (1,36), (1,515) bitwise, pairdot within
   PAIRDOT_TOL with +0.0 on padded slots (also with a and c one element off
   alignment at (4,256)), slot_gather and slot_gather_bwd at W = 1, 2, 3,
   4, 5, 12, 48 bitwise, every backward deterministic, pairdot and
   slot_gather_bwd again on a table with holes, and edge cases at D=128
   and D=7 (f32 and bf16); and a small GAT with attention dropout must
   train on the card;
4. serve: one 240x240x155 synthetic brain written as NIfTI, GSpool [256]*6 and
   CNN 8->16->4 checkpoints from seeded weights in the JAX package's format,
   three requests through cli.predict_single.predict_single_mri under "exact"
   and three under "fast" (native SLIC). Every request must launch the kernel
   7 times (once per GSpool layer) and return (240,240,155) int16 BraTS
   labels; once per mode the GNN logits are recomputed with the plain
   aggregation on the card and compared with the kernel path's. One exact
   request with cnn_prep="host" must give the device variant's labels. One
   more exact request runs under torch.profiler for the device's busy time
   and the kernels that fill it. Then the GAT cell: the hardcoded GAT with
   seed-0 weights, one request "exact" and one "fast", each launching the
   fused forward 5 times, with logits within GAT_LOGIT_TOL (exact) or
   FAST_LOGIT_TOL (fast) of the plain path's;
4b. device preprocessing, the cell serve-1mri-deviceprep: the same brain
   and checkpoints through predict_single_mri(prep_impl="device"), three
   requests "exact" and three "fast" (7 max_agg launches each and no other
   kernel), one GAT request "exact" (5 gat_fwd), one exact request through
   --slic_impl tpu (host normalization, SLIC on the card); before them the
   chain (ops/slic_device.py) on the brain's crop: q and the standardized
   volume bitwise equal to the host's normalize/standardize, a fast-mode
   call on a non-integral copy held to the quantile of its bfloat16-rounded
   values, the Gaussian within CHAIN_SMOOTH_TOL of scipy, the raw SLIC
   labels in >= CHAIN_SLIC_AGREEMENT of the voxels like the host canonical's
   (native), two runs bitwise equal, the standardized volume on the card.
   Then the chain's device time by part (upload, order statistics, affine,
   smoothing, assignment and update passes) with launches and the
   assignment pass's byte bound, a profiled device-prep request beside
   phase 4's profiled host-prep one (busy time, idle share, the final
   labels they share), and `python -m gnn_tumor_seg_tpu_torch.cli.warmup
   --slic_impl tpu` in its own process;
5. serve timing, on the served graph's own neighbour table (N=12288, D=16
   for this brain): max_agg checked bitwise against its plain version once
   more at F=20 and 256 in both dtypes, then its device time (CUDA-graph
   replay), its eager call time, its plain version, the library call
   F.embedding_bag(mode="max") and its byte bound, per request (1 launch at
   F=20, 6 at F=256);
6. training, the cells train-gspool-7x256-b6 and train-gat-b6: 6 graphs of
   7000 nodes (k=10, padded to 8192 x 12) written as a preprocessed data
   directory, then cli.train_gnn.main on the card: GSpool [256]*6 and the
   hardcoded GAT for 3 epochs each in "fast" (the loss must fall) and 1 in
   "exact", GSmean and GSgcn for 1 epoch each. Each run's kernel launches
   must be what the model needs (GSpool: 7 max_agg with the store and 7
   max_agg_bwd per step; GSmean and GSgcn: 7 sum_agg forward and 6 backward
   per step; 7 per evaluation batch; GAT: 5 gat_fwd, 5 gat_bwd and 5
   gat_rev per step and 5 gat_fwd per evaluation batch); the GSpool and GAT
   checkpoints must serve through load_gnn_from_checkpoint; on one batch in
   "exact" the parameter gradients through the kernels must equal those
   through the plain versions, bitwise for the three SAGE models and within
   GAT_GRAD_TOL for GAT. Then the weighted cells: preprocess-weighted-2mri
   (two 240x240x155 brains through cli.preprocess --weighted, then GSmean
   one fast epoch on that store through cli.train_gnn; then the same two
   brains through cli.preprocess --prep_impl device, whose inputs must be
   bitwise the host store's, and through --slic_impl tpu --prep_impl host,
   whose partitions, edges and labels the device store must have, with
   features within CHAIN_SMOOTH_TOL), and
   train-gsmean-weighted-b6 (the same 6 graphs with intensity edge weights,
   sigma 0.1: GSmean and GSgcn [256]*6, 3 fast epochs with a falling loss
   and 1 exact, 7 wsum and 6 wsum_bwd per step, 7 wsum per evaluation
   batch, no pairdot and no sum_agg; gradients bitwise equal to the plain
   path's); and train-gat-attndrop-b6 (the hardcoded GAT with attn_drop=0.1
   through GNNTrainer: 5 slot_gather, 5 wsum, 5 wsum_bwd, 5 pairdot and 5
   slot_gather_bwd per step, 3 fast epochs with a falling loss and 1 exact;
   gradients within GAT_GRAD_TOL of the plain path's under one generator
   seed);
7. training timing: the flagship GSpool step, the GAT step, the weighted
   GSmean step, the GAT step with attention dropout and, last, the GSmean
   step (7 sum_agg forward, 6 backward) in "exact" and
   "fast" (median step time, edges_per_s), torch.profiler over 3 more steps
   of each (device busy and idle share, top kernels), and per kernel at the
   batch's own table (B=6, N=8192, D=12): device time (CUDA-graph replay),
   plain version, library yardstick (embedding_bag's sum and mean, the
   backward alone of its max, and its max forward; partial yardsticks for
   the three GAT kernels: the weighted embedding_bag for the forward's
   combine, its per-sample-weight backward for the backward's d_alpha and
   its weight backward for the reverse combine's d_z; for wsum, wsum_bwd
   and pairdot the
   weighted embedding_bag's forward, its weight backward and its
   per-sample-weight backward; for slot_gather and slot_gather_bwd
   F.embedding and its backward) and byte bound; slot_gather at every width
   of phase 3;
8. the pipeline, the cell pipeline-2mri: the four steps of
   scripts/run_pipeline_cuda.sh as a user runs them (each CLI's main) on
   phase 6's two brains preprocessed with cli.preprocess: cli.train_gnn -m
   GSpool -k 1 ([256]*6, 2 epochs), cli.generate_gnn_predictions -f logits
   and once -f preds, cli.train_refinement_cnn -k 1 (the hardcoded CNN,
   3 epochs, the later ones from the prep cache) and
   cli.generate_joint_predictions --precision exact, then fast. Every step
   writes its files (labels 240x240x155 in {0,1,2,4}, finite logits), the
   kernel counts of each step are what GSpool needs (7 max_agg a brain or
   step and evaluation batch, 7 max_agg_bwd a step; none in the CNN step),
   the prep cache is hit by each brain from epoch 2 on and by the
   evaluation. Then one exact CNN step at 48^3 on the card against the
   same step on the CPU, two exact epochs from one seed compared bitwise,
   the CNN step at the floored crop timed (exact, fast, exact with
   cudnn.deterministic, and both with cudnn.benchmark; CUDA events) with
   its achieved TFLOP/s, and a cached fast and exact epoch profiled;
9. distributed training, the cell train-dist-2rank: phase 6's 6 graphs
   through six cli.train_gnn --parallel commands run at once, 2 fast epochs
   each: dp --mesh 2 (two ranks on the one card over gloo) and --mesh 1
   (NCCL at world size 1) GSpool [256]*6, and halo --mesh 2 on the union of
   the 6 graphs (42 000 nodes), p2p and all_gather, GSpool and the
   hardcoded GAT (the all_gather GAT run as one command a rank through
   --coordinator, the others spawning their ranks). Every run: the loss
   falls, each rank launches what a step needs (7 max_agg and 7 max_agg_bwd
   for GSpool; 5 gat_fwd, 5 gat_bwd and 5 gat_rev for GAT), rank 0 alone
   writes one progress row and the epoch records, and its checkpoint serves
   through load_gnn_from_checkpoint. In a two-rank world of its own, in
   "exact", through the trainers' own loss_and_grads (the step short of
   AdamW): DP logits within DIST_LOGIT_TOL, loss within 1e-5 and summed
   gradients within DIST_GRAD_TOL of one device's on the same batch, and
   for every halo model (the p2p exchange staged through host memory) the
   own-row logits, loss and summed gradients within the same tolerances of
   one device's on the union; on the rank tables themselves ((2W + shard)
   rows for p2p, the union's for all_gather), max_agg and max_agg_bwd
   bitwise and the three GAT kernels within their phase 3 tolerances of
   their plain versions. Logged with the card: each regime's fast step beside one
   device's (two ranks sharing one card give no scaling number) and the
   analytic bytes a rank exchanges a step;
10. tensor parallelism, on the one card at --mesh 1,2 (two model ranks over
   gloo, staged): `cli.train_gnn --parallel dp --mesh 1,2 -m GSpool` for 2
   fast epochs (the loss falls, each rank launches 7 max_agg and 7
   max_agg_bwd a step on its column blocks, rank 0 alone writes, its
   checkpoint of the whole model serves on one device), started alongside
   a world of its own in which GSpool [256]*6 and the hardcoded GAT,
   through ParallelGNNTrainer.loss_and_grads in "exact" on 2 graphs of the
   training shape, give logits within DIST_LOGIT_TOL, a loss within 1e-6
   relative and gathered gradients within DIST_GRAD_TOL of one device's,
   each rank launching every kernel of the step (the GAT's 4-head layers
   on 2 heads a rank); each model's fast step timed beside one device's,
   with the analytic bytes of the model-group collectives;
11. import, then serve: a DGL-layout GSpool state_dict ([256]*6) and a
   CnnRefinementNet one, built from seeded arrays and saved with
   torch.save, converted by `python -m
   gnn_tumor_seg_tpu_torch.cli.import_torch_weights`; one exact
   predict_single_mri request with the imported checkpoints (7 max_agg
   launches) whose labels lie in {0,1,2,4} and equal bitwise those of a
   request with checkpoints written straight from the same arrays; then
   viz.helpers.load_plotting_data on that prediction, with no matplotlib
   imported.

The line before the last is the card's name and power limit as nvidia-smi
prints them; before it, one JSON line lists the kernels. The last line is
{"ok": true, "device": {...}}. With no CUDA device, or outside a checkout of
the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BRAIN_SHAPE = (240, 240, 155)
NUM_NODES = 15000
IN_FEATS = 20                   # 5 quantiles x 4 modalities
GNN_WIDTHS = [256] * 6          # 7 SAGEConv-pool layers (scripts/bench_serve.py:83)
REQUESTS_PER_MODE = 3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# fast mode: bf16 activations through 7 layers; logits of the kernel and the
# plain path are expected bitwise equal (max is exact), this bounds them anyway
FAST_LOGIT_TOL = 1e-2
# GAT, exact: kernel-path logits against the plain path's, relative to the
# largest logit (the fused forward may differ from its plain version by an
# ulp of exp per layer; five layers and their matmuls carry it)
GAT_LOGIT_TOL = 1e-5
# GAT, exact: parameter gradients through the kernels against the plain
# path's, relative to each tensor's largest entry
GAT_GRAD_TOL = 1e-4
# the training cell, train-gspool-7x256-b6 (bench.py:147-161): 6 graphs of
# 7000 nodes, k=10, padded to the 8192-node bucket (degree bucket 12)
TRAIN_BATCH = 6
TRAIN_NODES = 7000
TRAIN_K = 10
TRAIN_WIDTHS = [256] * 6
# widths of the training kernel check: the model's 20 and 256 and, for
# max_agg_bwd's vectors, a scalar width and one of vectors of 4 that is no
# multiple of 8
TRAIN_KERNEL_WIDTHS = (3, 20, 36, 256)
# the widths of a GSpool pool layer's column block under tensor parallelism
# (phase 10): 10 and 128 at M = 2, 5 and 64 at M = 4
TP_KERNEL_WIDTHS = (5, 10, 64, 128)
# the max-aggregation widths of phase 10's path (M = 2), timed in phase 7
TP_WIDTHS = (IN_FEATS // 2, TRAIN_WIDTHS[0] // 2)
# the hardcoded GAT's head-parallel layers under tensor parallelism: its
# 4-head layers hold 2 heads a rank at M = 2 and 1 at M = 4 ((H, F,
# activation, residual), as gat_layers())
TP_GAT_LAYERS = [(2, 256, "elu", False), (1, 256, "elu", False)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_brain(rng, shape=BRAIN_SHAPE, radii=(36, 24, 12)):
    """Synthetic BraTS-like brain: 4 int16 modalities with an ellipsoid brain
    and a 3-class spherical tumor (copy of scripts/full_scale_smoke.py)."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    center = np.array(shape) / 2 + rng.integers(-10, 11, 3)
    r = np.linalg.norm((grid - center) / (np.array(shape) / 2.4), axis=-1)
    brain = r < 1.0
    tumor_c = center + rng.integers(-40, 41, 3)
    tr = np.linalg.norm(grid - tumor_c, axis=-1)
    labels = np.zeros(shape, np.int16)
    labels[(tr < radii[0]) & brain] = 2
    labels[(tr < radii[1]) & brain] = 1
    labels[(tr < radii[2]) & brain] = 4
    offsets = {2: (200, 60, 40, 160), 1: (90, 40, -120, 70), 4: (110, 70, 260, 90)}
    mods = []
    for m in range(4):
        vol = np.zeros(shape, np.int16)
        vol[brain] = 300 + 60 * m + rng.integers(0, 80, int(brain.sum()))
        for cls, off in offsets.items():
            sel = labels == cls
            vol[sel] += off[m] + rng.integers(-20, 21, int(sel.sum())).astype(np.int16)
        mods.append(vol)
    return mods, labels


# ---------------------------------------------------------------------------
# phases 1-2
# ---------------------------------------------------------------------------


def phase_environment() -> dict:
    from gnn_tumor_seg_tpu_torch.build import nvcc_path

    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  cudnn {torch.backends.cudnn.version()}")
    try:
        import triton
        log(f"[env] triton {triton.__version__}")
    except ImportError:
        log("[env] triton not importable")
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log("[env] nvcc: " + nvcc.splitlines()[-1])
    card = card_line()
    log(f"[env] card (name, power limit): {card}")
    log(f"[env] devices: {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}")
    return {"card": card}


def phase_build() -> None:
    """Every library from its source, one compiler process each, all started
    together."""
    from gnn_tumor_seg_tpu_torch.build import build_all
    from gnn_tumor_seg_tpu_torch.data import native

    for name, (out, secs) in build_all(cuda=True).items():
        log(f"[build] {name}: {secs:.2f} s")
        if name.endswith("(nvcc sm_90a)"):
            for line in out.strip().splitlines():
                log(f"[build]   {line}")
            for kern, regs, stores, loads in ptxas_kernels(out):
                if any(k in kern for k in ("wsum_kernel", "gat_fwd_kernel",
                                           "gat_bwd_kernel", "gat_rev_kernel",
                                           "sum_agg_kernel", "max_agg_kernel",
                                           "pairdot_kernel",
                                           "slot_gather_bwd_kernel")):
                    log(f"[build] {kern}: {regs} registers, spill stores "
                        f"{stores} B, spill loads {loads} B")
                    check(stores == loads == 0, f"{kern} spills registers")
    check(native.available(), "native host library did not load")


def ptxas_kernels(build_log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers a thread, spill store bytes, spill load bytes) of
    each entry function in nvcc's -Xptxas=-v output, names demangled when
    c++filt is there and cut at their argument list."""
    import re
    import shutil

    found, name, spills = [], None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.append((name, int(m.group(1)), *spills))
            name = None
    if found and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(f[0] for f in found),
                               capture_output=True, text=True, timeout=60).stdout
        found = [(n.replace("(anonymous namespace)::", "").split("(")[0]
                  .removeprefix("void "), *rest)
                 for n, (_, *rest) in zip(names.splitlines(), found)]
    return found


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def random_tables(rng, B, N, D, n_real=None, zero_frac=0.05, tie_frac=0.1):
    """nbr/mask as ops/graph.ell_from_edges lays them out: real slots first,
    padded slots 0; some zero-degree rows; some rows whose first two slots
    name the same neighbour (ties)."""
    n_real = N if n_real is None else n_real
    deg = rng.integers(1, D + 1, size=(B, N))
    deg[rng.random((B, N)) < zero_frac] = 0
    deg[:, n_real:] = 0
    nbr = rng.integers(0, n_real, size=(B, N, D)).astype(np.int32)
    if D > 1:
        tie = rng.random((B, N)) < tie_frac
        nbr[..., 1][tie] = nbr[..., 0][tie]
    mask = (np.arange(D)[None, None, :] < deg[..., None]).astype(np.float32)
    nbr[mask == 0] = 0
    return nbr, mask


def _device_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def device_events(prof) -> list:
    """The profiler's device-side work (kernels, copies, memsets) by name,
    most time first. The device ranges of user annotations
    (record_function, e.g. gnn_train_step, Optimizer.step) span other work
    and are left out, or busy time would count that work twice."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=_device_us, reverse=True)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def phase_kernel_check(dev) -> float:
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_plain)

    rng = np.random.default_rng(SEED)
    cases = [(1, 8192, d, f, {}) for d in (12, 16) for f in (20, 256)]
    cases += [
        (1, 8192, 16, 20, {"zero_frac": 1.0}),      # every row without a slot
        (1, 8192, 12, 256, {"n_real": 7000}),      # padded nodes, as served
        (1, 1001, 1, 20, {}),                      # D=1, N not a block multiple
        (2, 777, 12, 300, {}),                     # B=2, F not a lane multiple
        (1, 333, 128, 37, {"zero_frac": 0.3}),     # the largest degree bucket
    ]
    worst = 0.0
    for B, N, D, F, kw in cases:
        nbr_np, mask_np = random_tables(rng, B, N, D, **kw)
        nbr = torch.from_numpy(nbr_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        h32 = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            h = h32.to(dtype)
            want_out, want_arg = max_aggregate_plain(h, nbr, mask)
            for with_arg in (True, False):
                out, arg = max_aggregate(h, nbr, mask, with_arg=with_arg)
                torch.cuda.synchronize()
                err = (out.float() - want_out.float()).abs().max().item()
                worst = max(worst, err)
                tag = (f"B={B} N={N} D={D} F={F} {str(dtype)[6:]} "
                       f"arg={'stored' if with_arg else 'skipped'} {kw or ''}")
                check(torch.equal(_bits(out), _bits(want_out)),
                      f"kernel out differs from plain ({tag}): max abs {err}")
                if with_arg:
                    check(torch.equal(arg, want_arg),
                          f"kernel arg differs from plain ({tag})")
                log(f"[kernel] bitwise equal: {tag}")
    return worst


def symmetric_tables(rng, B, N, D, n_real=None, isolated_frac=0.05):
    """nbr/mask/rslot of random undirected, deduplicated graphs with degree
    at most D, laid out by ops/graph.ell_from_edges: some isolated nodes and,
    past n_real, padded nodes (both rows without a real slot). An edge is
    kept when it is among the first D candidates of both its ends, so no
    row overflows."""
    from gnn_tumor_seg_tpu_torch.ops.graph import ell_from_edges, reciprocal_slots

    n_real = N if n_real is None else n_real
    nbrs, masks = [], []
    for _ in range(B):
        live = np.nonzero(rng.random(n_real) >= isolated_frac)[0]
        m = len(live) * D // 2
        a, c = rng.choice(live, m), rng.choice(live, m)
        pairs = np.unique(np.sort(np.stack([a[a != c], c[a != c]], 1), 1), axis=0)
        pairs = pairs[rng.permutation(len(pairs))]
        ends = pairs.reshape(-1)                       # [a0, c0, a1, c1, ...]
        order = np.argsort(ends, kind="stable")
        first = np.searchsorted(ends[order], ends[order])
        rank = np.empty(len(ends), np.int64)
        rank[order] = np.arange(len(ends)) - first
        keep = (rank.reshape(-1, 2) < D).all(axis=1)
        e = pairs[keep]
        nbr, mask = ell_from_edges(n_real, np.concatenate([e[:, 0], e[:, 1]]),
                                   np.concatenate([e[:, 1], e[:, 0]]),
                                   n_pad=N, d_pad=D)
        nbrs.append(nbr)
        masks.append(mask)
    nbr, mask = np.stack(nbrs), np.stack(masks)
    return nbr, mask, reciprocal_slots(nbr, mask)


def phase_train_kernel_check(dev, N=8192, n_real=TRAIN_NODES,
                             B=TRAIN_BATCH) -> dict:
    """The training kernels against their plain versions on the card at the
    training shapes (B=6, N=8192 of which 7000 real, D=12/16, f32 and bf16)
    at TRAIN_KERNEL_WIDTHS (vectors of 1 to 4 in f32 or 8 in bf16) and, at
    D=12, at TP_KERNEL_WIDTHS,
    on random symmetric tables with ties and rows without a neighbour:
    max_agg with its winner-slot store, its serve variant (out bitwise equal
    to the store variant's), max_agg_bwd, and sum_agg (sum and mean),
    bitwise; two runs of max_agg_bwd and sum_agg bitwise equal to each other
    (determinism). The same at D=12 on a table with holes (real slots after
    padded ones), with h and gout one element off alignment (vectors of 1),
    at the largest degree bucket (D=128; F=6, vectors of 2) and at F=515,
    where 515 vectors of 1 take three blocks a row. Returns the largest
    difference seen per kernel (0 when bitwise)."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_backward, max_aggregate_backward_plain,
        max_aggregate_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.sum_agg import (
        sum_aggregate, sum_aggregate_plain)

    rng = np.random.default_rng(SEED + 1)
    worst = {"max_agg": 0.0, "max_agg_bwd": 0.0, "sum_agg": 0.0}

    def same(got, want, kernel, tag):
        err = (got.float() - want.float()).abs().max().item()
        worst[kernel] = max(worst[kernel], err)
        check(torch.equal(_bits(got), _bits(want)),
              f"{kernel} differs from its plain version ({tag}): max abs {err}")

    def run_case(B, N, D, n_real, widths, holes=False, shift=False):
        nbr_np, mask_np, rslot_np = symmetric_tables(rng, B, N, D, n_real=n_real)
        if holes:
            mask_np = punch_holes(rng, nbr_np, mask_np, rslot_np)
        nbr, mask, rslot = (torch.from_numpy(a).to(dev)
                            for a in (nbr_np, mask_np, rslot_np))
        for F in widths:
            shape = (B, N, F)
            # quarter steps: many exact ties among neighbours, exact in bf16
            ties = torch.from_numpy(rng.integers(-8, 8, shape) / 4.0).float().to(dev)
            gout32 = randn_on(rng, shape, dev)
            for dtype in (torch.float32, torch.bfloat16):
                tag = (f"B={B} N={N} D={D} F={F} {str(dtype)[6:]}"
                       + " holed" * holes + " misaligned" * shift)
                h, gout = ties.to(dtype), gout32.to(dtype)
                if shift:
                    h, gout = misaligned(h), misaligned(gout)
                out, arg = max_aggregate(h, nbr, mask, with_arg=True)
                want_out, want_arg = max_aggregate_plain(h, nbr, mask)
                same(out, want_out, "max_agg", tag)
                check(torch.equal(arg, want_arg), f"max_agg arg differs ({tag})")
                served, _ = max_aggregate(h, nbr, mask, with_arg=False)
                check(torch.equal(_bits(served), _bits(out)),
                      f"max_agg's serve variant differs from its store variant ({tag})")
                grad = max_aggregate_backward(gout, arg, nbr, mask, rslot)
                again = max_aggregate_backward(gout, arg, nbr, mask, rslot)
                same(grad, max_aggregate_backward_plain(gout, arg, nbr, mask, rslot),
                     "max_agg_bwd", tag)
                check(torch.equal(_bits(grad), _bits(again)),
                      f"max_agg_bwd is not deterministic ({tag})")
                for mean in (False, True):
                    x = gout if mean else h
                    got = sum_aggregate(x, nbr, mask, mean)
                    again = sum_aggregate(x, nbr, mask, mean)
                    same(got, sum_aggregate_plain(x, nbr, mask, mean), "sum_agg",
                         f"{tag} {'mean' if mean else 'sum'}")
                    check(torch.equal(_bits(got), _bits(again)),
                          f"sum_agg is not deterministic ({tag})")
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                log(f"[kernel] bitwise equal to plain, deterministic: {tag}: "
                    f"max_agg (arg stored, and its serve variant), max_agg_bwd, "
                    f"sum_agg sum and mean")

    for D in (12, 16):
        run_case(B, N, D, n_real, TRAIN_KERNEL_WIDTHS)
    run_case(B, N, 12, n_real, TP_KERNEL_WIDTHS)
    # real slots after padded ones
    run_case(B, N, 12, n_real, TRAIN_KERNEL_WIDTHS, holes=True)
    # h and gout one element off alignment: vectors of 1
    run_case(B, N, 12, n_real, (IN_FEATS, TRAIN_WIDTHS[0]), shift=True)
    # the largest degree bucket, N not a multiple of any block's rows
    run_case(2, 777, 128, 700, (6, 256))
    # more than 256 vectors a row (F odd: vectors of 1)
    run_case(1, 300, 12, 300, (515,))
    return worst


def gat_layers() -> list[tuple[int, int, str | None, bool]]:
    """The hardcoded GAT's layers as the model factory builds them for the
    main path: (heads, features, activation, residual); ELU on every layer
    but the output layer."""
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net

    specs = init_graph_net("GAT", hardcoded_hyperparameters("GAT")).specs
    return [(heads, out, None if i == len(specs) - 1 else "elu", res)
            for i, (_, out, heads, res) in enumerate(specs)]


def gat_head_shapes(layers) -> list[tuple[int, int]]:
    """The distinct (heads, features) of `layers`, in layer order."""
    return list(dict.fromkeys((h, f) for h, f, _, _ in layers))


# kernel against plain, relative to the largest |value| of the result: the
# forward differs only where CUDA's expf and torch's exp differ (an ulp);
# the backward's dot over F sums in a shuffle tree, torch in its own order.
# A bf16 output may round to the neighbouring bf16 value (1 ulp) beyond that.
GAT_FWD_TOL = 1e-6
GAT_BWD_TOL = 1e-5


def within(got, want, bf16_ulp=False) -> float:
    """max |got - want| / max |want|, after allowing one bf16 ulp of want
    per element when asked; the caller compares it with its tolerance."""
    diff = (got.float() - want.float()).abs()
    if bf16_ulp:
        _, e = torch.frexp(want.float())
        diff = (diff - torch.ldexp(torch.ones_like(diff), e - 8)).clamp_min(0)
    return diff.max().item() / max(want.float().abs().max().item(), 1e-30)


def randn_on(rng, shape, dev) -> torch.Tensor:
    """Standard normal float32 values of `shape` drawn on `dev` from a torch
    generator seeded from `rng`: at the training shapes a draw on the card
    costs far less than numpy's on the host and its copy."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 62)))
    return torch.randn(shape, generator=gen, device=dev)


def gat_inputs(rng, B, N, H, F, dtype, dev):
    """z, el, er, res, bias, gout of one layer. el and er are quarter steps,
    so many logits tie and many pre-activations are exactly 0 (LeakyReLU'
    takes the >= 0 branch there)."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)
    return {"z": randn_on(rng, (B, N, H, F), dev).to(dtype),
            "el": t(rng.integers(-8, 8, (B, N, H)) / 4.0),
            "er": t(rng.integers(-8, 8, (B, N, H)) / 4.0),
            "res": randn_on(rng, (B, N, H * F), dev).to(dtype),
            "bias": randn_on(rng, (H * F,), dev).to(dtype),
            "gout": randn_on(rng, (B, N, H, F), dev).to(dtype)}


def punch_holes(rng, nbr, mask, rslot, frac=0.15):
    """A copy of `mask` with both ends of a fraction of the edges masked
    off: rows then have real slots after padded ones (a prefix-packed
    table never does), padded slots keep their neighbour ids, and the
    table stays symmetric with `rslot` still valid."""
    mask = mask.copy()
    b, v, d = np.nonzero((mask > 0) & (rng.random(mask.shape) < frac))
    mask[b, v, d] = 0
    mask[b, nbr[b, v, d], rslot[b, v, d]] = 0
    check(((mask[..., 1:] > 0) & (mask[..., :-1] == 0)).any(),
          "the holed table has no real slot after a padded one")
    return mask


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element past an aligned
    address, so the kernels can only take vectors of 1."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_gat_kernel_check(dev, N=8192, n_real=TRAIN_NODES, B=TRAIN_BATCH) -> dict:
    """The three fused GAT kernels against their plain versions on the card
    at the training shapes (B=6, N=8192 of which 7000 real, D=12/16, the
    hardcoded GAT's (H,F), at D=12 its head-parallel layers'
    (TP_GAT_LAYERS), and GAT_VECTOR_SHAPES, f32 and bf16), on random
    symmetric tables with isolated rows, with tied logits, residual and ELU
    on and off: the forward within GAT_FWD_TOL (bf16 output: 1 ulp beyond
    it), its sign mask bitwise, the serve variant (no stores) bitwise equal
    to the training one and two runs bitwise equal; the backward within
    GAT_BWD_TOL and deterministic; the reverse combine bitwise and
    deterministic. The forward and the backward also on the same tables
    with holes (punch_holes: real slots after padded ones) and with z and
    gout one element off alignment (vectors of 1) at (H,F) = (4,256). Then
    all of it at D=128, H=6, F=2 (f32 and bf16), with and without holes.
    Returns the largest difference per kernel, relative ("rel") and
    absolute ("abs")."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import (
        fused_gat_backward, fused_gat_backward_plain, fused_gat_forward,
        fused_gat_forward_plain, gat_reverse_combine, gat_reverse_combine_plain)

    head_shapes = gat_head_shapes(gat_layers())
    rng = np.random.default_rng(SEED + 2)
    worst = {"gat_fwd": 0.0, "gat_bwd": 0.0, "gat_rev": 0.0}
    worst_abs = dict(worst)

    def seen(kernel, *pairs):
        worst_abs[kernel] = max([worst_abs[kernel]] + [
            (a.float() - b.float()).abs().max().item() for a, b in pairs])

    def same(a, b):
        return torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)

    def run_case(table, nbr, mask, rslot, Bc, Nc, H, F, dtype, rev=True, offset=False):
        x = gat_inputs(rng, Bc, Nc, H, F, dtype, dev)
        z, gout = x["z"], x["gout"]
        if offset:
            z, gout = misaligned(z), misaligned(gout)
        bf16 = dtype == torch.bfloat16
        base = f"{table} B={Bc} N={Nc} D={nbr.shape[2]} H={H} F={F} {str(dtype)[6:]}"
        for act, with_res in (("elu", True), (None, False)):
            tag = f"{base} act={act} res={with_res}"
            args = (z, x["el"], x["er"], nbr, mask, 0.2, act,
                    x["res"] if with_res else None, x["bias"])
            out, alpha, pos = fused_gat_forward(*args, save=True)
            again = fused_gat_forward(*args, save=True)
            serve, _, _ = fused_gat_forward(*args, save=False)
            w_out, w_alpha, w_pos = fused_gat_forward_plain(*args)
            err = max(within(out, w_out, bf16), within(alpha, w_alpha))
            worst["gat_fwd"] = max(worst["gat_fwd"], err)
            seen("gat_fwd", (out, w_out), (alpha, w_alpha))
            check(err <= GAT_FWD_TOL, f"gat_fwd differs from its plain version "
                  f"({tag}): {err:.3g} of the largest value")
            check(torch.equal(pos, w_pos), f"gat_fwd sign mask differs ({tag})")
            check(torch.equal(_bits(serve), _bits(out)),
                  f"gat_fwd without stores differs from with them ({tag})")
            check(all(same(a, b) for a, b in zip(again, (out, alpha, pos))),
                  f"gat_fwd is not deterministic ({tag})")
        d_pre, d_er = fused_gat_backward(gout, z, alpha, pos, nbr, mask)
        again = fused_gat_backward(gout, z, alpha, pos, nbr, mask)
        w_pre, w_er = fused_gat_backward_plain(gout, z, alpha, pos, nbr, mask)
        err = max(within(d_pre, w_pre), within(d_er, w_er))
        worst["gat_bwd"] = max(worst["gat_bwd"], err)
        seen("gat_bwd", (d_pre, w_pre), (d_er, w_er))
        check(err <= GAT_BWD_TOL, f"gat_bwd differs from its plain version "
              f"({base}): {err:.3g} of the largest value")
        check(torch.equal(d_pre, again[0]) and torch.equal(d_er, again[1]),
              f"gat_bwd is not deterministic ({base})")
        done = "gat_fwd, gat_bwd"
        if rev:
            d_z, d_el = gat_reverse_combine(gout, alpha, d_pre, nbr, mask, rslot)
            again = gat_reverse_combine(gout, alpha, d_pre, nbr, mask, rslot)
            w_z, w_el = gat_reverse_combine_plain(gout, alpha, d_pre, nbr, mask, rslot)
            worst["gat_rev"] = max(worst["gat_rev"], within(d_z, w_z),
                                   within(d_el, w_el))
            seen("gat_rev", (d_z, w_z), (d_el, w_el))
            check(torch.equal(_bits(d_z), _bits(w_z)) and torch.equal(d_el, w_el),
                  f"gat_rev differs from its plain version ({base})")
            check(torch.equal(_bits(d_z), _bits(again[0]))
                  and torch.equal(d_el, again[1]),
                  f"gat_rev is not deterministic ({base})")
            done += ", gat_rev"
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"[kernel] {base}{' z/gout misaligned' if offset else ''}: {done}: "
            f"gat_fwd within {GAT_FWD_TOL} (ELU+res and none), sign mask, serve "
            f"variant and second run bitwise; gat_bwd within {GAT_BWD_TOL}"
            + ("; gat_rev bitwise" if rev else "") + "; deterministic")

    def tables(Bc, Nc, D, nr):
        nbr_np, mask_np, rslot_np = symmetric_tables(rng, Bc, Nc, D, n_real=nr)
        holed = punch_holes(rng, nbr_np, mask_np, rslot_np)
        nbr, rslot = (torch.from_numpy(a).to(dev) for a in (nbr_np, rslot_np))
        return nbr, rslot, torch.from_numpy(mask_np).to(dev), torch.from_numpy(holed).to(dev)

    for D in (12, 16):
        nbr, rslot, mask, holed = tables(B, N, D, n_real)
        # the head-parallel layers of phase 10 on the D=12 tables
        tp_shapes = gat_head_shapes(TP_GAT_LAYERS) if D == 12 else []
        for H, F in head_shapes + tp_shapes + GAT_VECTOR_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                run_case("packed", nbr, mask, rslot, B, N, H, F, dtype)
                run_case("holes", nbr, holed, rslot, B, N, H, F, dtype, rev=False)
        for dtype in (torch.float32, torch.bfloat16):
            run_case("packed", nbr, mask, rslot, B, N, 4, 256, dtype, rev=False,
                     offset=True)
    # edge case: the largest degree bucket, 6 heads (random configurations
    # draw 3-6), F=2, N not a multiple of any block's rows
    nbr, rslot, mask, holed = tables(2, 777, 128, 700)
    for dtype in (torch.float32, torch.bfloat16):
        run_case("packed", nbr, mask, rslot, 2, 777, 6, 2, dtype)
        run_case("holes", nbr, holed, rslot, 2, 777, 6, 2, dtype, rev=False)
    log(f"[kernel] GAT kernels against plain, largest difference relative to "
        f"the largest value: {worst}; absolute: {worst_abs}")
    return {"rel": worst, "abs": worst_abs}


# pairdot against its plain version, relative to the largest |score|: the
# kernel's dot over F runs in lanes and a shuffle tree, torch in its own order
PAIRDOT_TOL = 1e-6
DECOMPOSED_SHAPES = [(1, 20), (1, 256), (4, 256), (3, 256), (1, 4)]
# (H,F) beyond the main path's that reach every vector width of the combines
# (wsum, wsum_bwd, gat_rev): vectors of 1 (F=3), 2 (F=6) and 4 (F=36), and
# at F=515 vectors of 1 over three runs of 256 threads (the third grid
# dimension); bf16 reaches vectors of 8 at the main path's F=256
VECTOR_SHAPES = [(1, 3), (2, 6), (1, 36), (1, 515)]
GAT_VECTOR_SHAPES = [(2, 36), (3, 6), (1, 515)]
SLOT_WIDTHS = [1, 2, 3, 4, 5, 12, 48]


def phase_decomposed_kernel_check(dev, N=8192, n_real=TRAIN_NODES,
                                  B=TRAIN_BATCH) -> dict:
    """The weighted combine (wsum), its reverse (wsum_bwd), the pair dot
    (pairdot) and the slot gather with its backward against their plain
    versions on the card at the training shapes (B=6, N=8192 of which 7000
    real, D=12/16, f32 and bf16), on random symmetric tables with isolated
    rows and with weights that are not symmetric and nonzero on padded slots:
    wsum and wsum_bwd at DECOMPOSED_SHAPES and VECTOR_SHAPES bitwise, pairdot
    within PAIRDOT_TOL of the largest value and +0.0 on padded slots (also
    with a and c one element off alignment at (4,256)), slot_gather and
    slot_gather_bwd at SLOT_WIDTHS bitwise; two runs each of wsum, wsum_bwd,
    pairdot and slot_gather_bwd bitwise equal; pairdot and slot_gather_bwd
    again on the D=12 table with holes (punch_holes); then edge cases at
    D=128 and D=7 (f32 and bf16). Returns the largest difference per
    kernel, relative ("rel") and absolute ("abs")."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.slot_gather import (
        slot_gather, slot_gather_backward, slot_gather_backward_plain,
        slot_gather_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum import (
        pairdot, pairdot_plain, weighted_sum, weighted_sum_plain,
        weighted_sum_reverse, weighted_sum_reverse_plain)

    rng = np.random.default_rng(SEED + 4)
    names = ("wsum", "wsum_bwd", "pairdot", "slot_gather", "slot_gather_bwd")
    worst = {k: 0.0 for k in names}
    worst_abs = dict(worst)

    def t(a, dtype=torch.float32):
        if isinstance(a, torch.Tensor):
            return a.to(dev, dtype)
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dtype)

    def same(kernel, got, want, again, tag):
        err = (got.float() - want.float()).abs().max().item()
        worst_abs[kernel] = max(worst_abs[kernel], err)
        worst[kernel] = max(worst[kernel], within(got, want))
        check(torch.equal(_bits(got), _bits(want)),
              f"{kernel} differs from its plain version ({tag}): max abs {err}")
        check(again is None or torch.equal(_bits(got), _bits(again)),
              f"{kernel} is not deterministic ({tag})")

    def check_pairdot(a, c, nbr, mask, tag):
        got = pairdot(a, c, nbr, mask)
        want = pairdot_plain(a, c, nbr, mask)
        err = within(got, want)
        worst["pairdot"] = max(worst["pairdot"], err)
        worst_abs["pairdot"] = max(worst_abs["pairdot"], (got - want).abs().max().item())
        check(err <= PAIRDOT_TOL, f"pairdot differs from its plain version ({tag}): "
              f"{err:.3g} of the largest value")
        check(torch.equal(got, pairdot(a, c, nbr, mask)),
              f"pairdot is not deterministic ({tag})")
        check(bool((_bits(got[mask == 0]) == 0).all()),
              f"pairdot is not +0.0 on a padded slot ({tag})")

    def run_case(B, N, D, n_real, shapes, widths, dtypes, holes=False):
        """holes: the table with real slots after padded ones (punch_holes),
        for pairdot and slot_gather_bwd alone"""
        nbr_np, mask_np, rslot_np = symmetric_tables(rng, B, N, D, n_real=n_real)
        if holes:
            mask_np = punch_holes(rng, nbr_np, mask_np, rslot_np)
        nbr, mask, rslot = (torch.from_numpy(a).to(dev)
                            for a in (nbr_np, mask_np, rslot_np))
        table = "holed " if holes else ""
        for H, F in shapes:
            w = randn_on(rng, (B, N, D, H), dev)     # padded slots too
            v32 = randn_on(rng, (B, N, H, F), dev)
            g32 = randn_on(rng, (B, N, H, F), dev)
            for dtype in dtypes:
                tag = f"{table}B={B} N={N} D={D} H={H} F={F} {str(dtype)[6:]}"
                values, gout = t(v32, dtype), t(g32, dtype)
                if not holes:
                    same("wsum", weighted_sum(values, w, nbr, mask),
                         weighted_sum_plain(values, w, nbr, mask),
                         weighted_sum(values, w, nbr, mask), tag)
                    same("wsum_bwd", weighted_sum_reverse(gout, w, nbr, mask, rslot),
                         weighted_sum_reverse_plain(gout, w, nbr, mask, rslot),
                         weighted_sum_reverse(gout, w, nbr, mask, rslot), tag)
                check_pairdot(gout, values, nbr, mask, tag)
                done = "pairdot within"
                if (H, F) == (4, 256):
                    # a and c one element off alignment: vectors of 1
                    check_pairdot(misaligned(gout), misaligned(values), nbr, mask,
                                  tag + " a/c misaligned")
                    done = "pairdot (a/c also misaligned) within"
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                log(f"[kernel] {tag}: "
                    + ("" if holes else "wsum and wsum_bwd bitwise, ")
                    + f"{done} {PAIRDOT_TOL} and +0.0 on padded slots, "
                    f"kernels deterministic")
        for W in widths:
            x32 = randn_on(rng, (B, N, W), dev)
            g32 = randn_on(rng, (B, N, D, W), dev)
            for dtype in dtypes:
                tag = f"{table}B={B} N={N} D={D} W={W} {str(dtype)[6:]}"
                x, gout = t(x32, dtype), t(g32, dtype)
                if not holes:
                    same("slot_gather", slot_gather(x, nbr, mask),
                         slot_gather_plain(x, nbr, mask), None, tag)
                same("slot_gather_bwd",
                     slot_gather_backward(gout, nbr, mask, rslot),
                     slot_gather_backward_plain(gout, nbr, mask, rslot),
                     slot_gather_backward(gout, nbr, mask, rslot), tag)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            log(f"[kernel] {table}B={B} N={N} D={D} W={W}: "
                + ("" if holes else "slot_gather and ")
                + "slot_gather_bwd bitwise (f32, bf16), backward deterministic")

    both = (torch.float32, torch.bfloat16)
    for D in (12, 16):
        run_case(B, N, D, n_real, DECOMPOSED_SHAPES + VECTOR_SHAPES, SLOT_WIDTHS,
                 both)
    run_case(B, N, 12, n_real, DECOMPOSED_SHAPES + VECTOR_SHAPES, SLOT_WIDTHS,
             both, holes=True)
    # the largest degree bucket, 6 heads, F=2, N not a multiple of any
    # block's rows; and a degree no bucket has (D=7: the slot gather's
    # backward reads its table one entry at a time)
    run_case(2, 777, 128, 700, [(6, 2)], [5], both)
    run_case(2, 777, 7, 700, [(2, 6), (4, 256)], [1, 3, 4, 5], both)
    log(f"[kernel] decomposed kernels against plain, largest difference "
        f"relative to the largest value: {worst}; absolute: {worst_abs}")
    return {"rel": worst, "abs": worst_abs}


def check_gat_dropout_trains(dev) -> None:
    """A small GAT with attention dropout takes the decomposed path on the
    card: finite logits and a backward through the slot gather, the
    weighted combine and their gradients."""
    from gnn_tumor_seg_tpu_torch.models.gat import GAT
    from gnn_tumor_seg_tpu_torch.ops.graph import graph_from_arrays

    model = GAT(IN_FEATS, [8], 4, [2], [False], attn_drop=0.5).to(dev)
    src = np.array([0, 1, 1, 2])
    dst = np.array([1, 0, 2, 1])
    graph = graph_from_arrays(np.ones((3, IN_FEATS), np.float32), src, dst,
                              rslot=True).to(dev)
    read = _reset_counts()
    logits = model(graph, train=True,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
    logits.sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    counts = read()
    check(bool(torch.isfinite(logits).all()), "GAT attention dropout: "
          "non-finite logits")
    want = ({**NO_LAUNCHES, "slot_gather": 2, "wsum": 2, "wsum_bwd": 2,
             "pairdot": 2, "slot_gather_bwd": 2} if dev.type == "cuda"
            else NO_LAUNCHES)
    check(counts == want, f"GAT attention dropout: launches {counts}, "
          f"expected {want}")
    log(f"[kernel] GAT attention dropout trains on {dev}: finite logits, "
        f"launches {counts}")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_aggregation():
    """Route every kernel (aggregation, GAT attention, the weighted combine,
    the pair dot and the slot gather, forward and backward) through its
    plain version for a comparison run on the card;
    the port itself never does this on a CUDA tensor."""
    from gnn_tumor_seg_tpu_torch.ops.kernels import (fused_gat, max_agg,
                                                     slot_gather, sum_agg,
                                                     weighted_sum)

    def plain_max(h, nbr, nbr_mask, with_arg=True):
        out, arg = max_agg.max_aggregate_plain(h, nbr, nbr_mask)
        return out, (arg if with_arg else None)

    swaps = [(max_agg, "max_aggregate", plain_max),
             (max_agg, "max_aggregate_backward",
              max_agg.max_aggregate_backward_plain),
             (sum_agg, "sum_aggregate", sum_agg.sum_aggregate_plain),
             (fused_gat, "fused_gat_forward", fused_gat.fused_gat_forward_plain),
             (fused_gat, "fused_gat_backward", fused_gat.fused_gat_backward_plain),
             (fused_gat, "gat_reverse_combine",
              fused_gat.gat_reverse_combine_plain),
             (weighted_sum, "weighted_sum", weighted_sum.weighted_sum_plain),
             (weighted_sum, "weighted_sum_reverse",
              weighted_sum.weighted_sum_reverse_plain),
             (weighted_sum, "pairdot", weighted_sum.pairdot_plain),
             (slot_gather, "slot_gather", slot_gather.slot_gather_plain),
             (slot_gather, "slot_gather_backward",
              slot_gather.slot_gather_backward_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def write_inputs(tmp: str, shape) -> tuple[str, str, str]:
    """The synthetic brain as NIfTI files and seeded GNN/CNN checkpoints;
    a seeded GAT checkpoint of the hardcoded configuration beside them, as
    gat.ckpt."""
    from gnn_tumor_seg_tpu_torch.config import HyperParams, hardcoded_hyperparameters
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
    from gnn_tumor_seg_tpu_torch.models.refine_cnn import CnnRefinementNet
    from gnn_tumor_seg_tpu_torch.train.checkpoint import save_checkpoint

    t = time.perf_counter()
    mods, _ = make_brain(np.random.default_rng(SEED), shape)
    in_dir = os.path.join(tmp, "input")
    os.makedirs(in_dir)
    for name, vol in zip(("flair", "t1", "t1ce", "t2"), mods):
        nifti.save_as_nifti(vol, os.path.join(in_dir, f"brain_{name}.nii.gz"))
    gen = torch.Generator().manual_seed(SEED)
    hp = HyperParams(in_feats=IN_FEATS, layer_sizes=list(GNN_WIDTHS))
    gnn_ckpt = os.path.join(tmp, "gnn.ckpt")
    save_checkpoint(gnn_ckpt, init_graph_net("GSpool", hp, gen), "GSpool", hp)
    cnn_ckpt = os.path.join(tmp, "cnn.ckpt")
    save_checkpoint(cnn_ckpt, CnnRefinementNet(8, 4, [16], generator=gen), "CNN",
                    HyperParams(in_feats=8, layer_sizes=[16]))
    gat_hp = hardcoded_hyperparameters("GAT")
    save_checkpoint(os.path.join(tmp, "gat.ckpt"), init_graph_net(
        "GAT", gat_hp, torch.Generator().manual_seed(SEED)), "GAT", gat_hp)
    log(f"[serve] wrote inputs {shape} in {time.perf_counter() - t:.2f} s")
    return in_dir, gnn_ckpt, cnn_ckpt


def gat_checkpoint(gnn_ckpt: str) -> str:
    """The GAT checkpoint write_inputs puts beside the GSpool one."""
    return os.path.join(os.path.dirname(gnn_ckpt), "gat.ckpt")


def phase_serve(device, shape=BRAIN_SHAPE, num_nodes=NUM_NODES,
                requests=REQUESTS_PER_MODE, card="", inputs=None) -> dict:
    """Drive predict_single_mri on `inputs` (write_inputs' triple; written
    to a temporary directory when None); returns the served graph and the
    kernel's launch total. On the CPU (a rehearsal) the kernel is never
    launched."""
    from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                    load_gnn_from_checkpoint,
                                                    resolve_slic_fn)
    from gnn_tumor_seg_tpu_torch.cli.predict_single import predict_single_mri
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import max_aggregate
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    on_card = torch.device(device).type == "cuda"
    result = {"launches": 0}
    with contextlib.ExitStack() as stack:
        if inputs is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="gts_smoke_"))
            inputs = write_inputs(tmp, shape)
        in_dir, gnn_ckpt, cnn_ckpt = inputs
        gnn, _, gnn_forward = load_gnn_from_checkpoint(gnn_ckpt, device=device)
        _, _, cnn_forward = load_cnn_from_checkpoint(cnn_ckpt, device=device)
        n_layers = gnn.num_layers
        seen = {}

        def capturing_forward(graph):
            logits = gnn_forward(graph)
            seen["graph"], seen["logits"] = graph, logits
            return logits

        preds = {}
        for mode in ("exact", "fast"):
            with precision_scope(mode):
                for r in range(requests):
                    st = {}
                    max_aggregate.launches = 0
                    t = time.perf_counter()
                    pred = predict_single_mri(
                        in_dir, capturing_forward, cnn_forward,
                        num_nodes=num_nodes, slic_fn=resolve_slic_fn("native"),
                        stage_times=st)
                    wall = time.perf_counter() - t
                    launches = max_aggregate.launches
                    result["launches"] += launches
                    if on_card:
                        check(launches == n_layers,
                              f"{mode} request {r}: {launches} kernel launches, "
                              f"expected {n_layers}")
                    check(pred.shape == tuple(shape) and pred.dtype == np.int16,
                          f"prediction {pred.shape} {pred.dtype}")
                    labels = set(np.unique(pred).tolist())
                    check(labels <= {0, 1, 2, 4}, f"labels {labels}")
                    check(bool(torch.isfinite(seen["logits"]).all()),
                          "non-finite GNN logits")
                    stages = {k: (round(v, 4) if isinstance(v, float) else v)
                              for k, v in st.items()}
                    log(f"[serve] {mode} request {r}: {wall:.3f} s  "
                        f"launches={launches}  labels={sorted(labels)}  "
                        f"stages={json.dumps(stages)}  card: {card}")
                preds[mode] = pred
                with plain_aggregation():
                    plain_logits = gnn_forward(seen["graph"])
                kern = seen["logits"]
                diff = (kern - plain_logits).abs().max().item()
                if mode == "exact":
                    check(torch.equal(kern, plain_logits),
                          f"exact: kernel-path logits differ from the plain "
                          f"path's (max abs {diff})")
                else:
                    check(torch.allclose(kern, plain_logits, rtol=FAST_LOGIT_TOL,
                                         atol=FAST_LOGIT_TOL),
                          f"fast: kernel-path logits differ from the plain "
                          f"path's beyond {FAST_LOGIT_TOL} (max abs {diff})")
                log(f"[serve] {mode}: GNN logits, kernel vs plain aggregation "
                    f"on {device}: max abs diff {diff}")
        agree = float((preds["exact"] == preds["fast"]).mean())
        log(f"[serve] exact vs fast label agreement: {agree:.6f}")
        # the host-assembled CNN crop (--cnn_prep host): same CNN input, so
        # the same labels as the device variant's
        with precision_scope("exact"):
            st = {}
            max_aggregate.launches = 0
            t = time.perf_counter()
            pred = predict_single_mri(
                in_dir, gnn_forward, cnn_forward, num_nodes=num_nodes,
                slic_fn=resolve_slic_fn("native"), stage_times=st,
                cnn_prep="host")
            wall = time.perf_counter() - t
            launches = max_aggregate.launches
        result["launches"] += launches
        if on_card:
            check(launches == n_layers,
                  f"cnn_prep=host request: {launches} kernel launches, "
                  f"expected {n_layers}")
        check(np.array_equal(pred, preds["exact"]),
              f"cnn_prep=host labels differ from cnn_prep=device in "
              f"{int((pred != preds['exact']).sum())} voxels")
        stages = {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in st.items()}
        log(f"[serve] exact request, cnn_prep=host: {wall:.3f} s  "
            f"launches={launches}  labels equal to cnn_prep=device  "
            f"stages={json.dumps(stages)}  card: {card}")
        result["graph"] = seen["graph"]
        if on_card:
            with precision_scope("exact"):
                result["profile"] = profile_request(lambda: predict_single_mri(
                    in_dir, gnn_forward, cnn_forward, num_nodes=num_nodes,
                    slic_fn=resolve_slic_fn("native")), n_layers, card)
            result["launches"] += result["profile"]["launches"]
        result["gat"] = serve_gat(in_dir, gat_checkpoint(gnn_ckpt),
                                  cnn_forward, device, num_nodes, shape, card)
    return result


def serve_gat(in_dir, gat_ckpt, cnn_forward, device, num_nodes, shape,
              card) -> dict:
    """The GAT serve cell: the hardcoded GAT (seed-0 weights) served through
    load_gnn_from_checkpoint and predict_single_mri, one request in "exact"
    and one in "fast". Each must launch the fused forward once per layer
    (5) and no backward kernel, return BraTS labels, and give node logits
    that agree with the plain path's on the card. Returns the launch
    total."""
    from gnn_tumor_seg_tpu_torch.cli.common import (load_gnn_from_checkpoint,
                                                    resolve_slic_fn)
    from gnn_tumor_seg_tpu_torch.cli.predict_single import predict_single_mri
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    on_card = torch.device(device).type == "cuda"
    gat, _, gat_forward = load_gnn_from_checkpoint(gat_ckpt, device=device)
    seen = {}

    def capturing_forward(graph):
        logits = gat_forward(graph)
        seen["graph"], seen["logits"] = graph, logits
        return logits

    total = 0
    for mode in ("exact", "fast"):
        with precision_scope(mode):
            st = {}
            read = _reset_counts()
            t = time.perf_counter()
            pred = predict_single_mri(in_dir, capturing_forward, cnn_forward,
                                      num_nodes=num_nodes,
                                      slic_fn=resolve_slic_fn("native"),
                                      stage_times=st)
            wall = time.perf_counter() - t
            counts = read()
            total += counts["gat_fwd"]
            if on_card:
                check(counts == {**NO_LAUNCHES, "gat_fwd": gat.num_layers},
                      f"GAT {mode} request: kernel launches {counts}, expected "
                      f"{gat.num_layers} gat_fwd")
            labels = set(np.unique(pred).tolist())
            check(pred.shape == tuple(shape) and pred.dtype == np.int16,
                  f"GAT prediction {pred.shape} {pred.dtype}")
            check(labels <= {0, 1, 2, 4}, f"GAT labels {labels}")
            kern = seen["logits"]
            check(bool(torch.isfinite(kern).all()), "non-finite GAT logits")
            with plain_aggregation():
                plain = gat_forward(seen["graph"])
            tol = GAT_LOGIT_TOL if mode == "exact" else FAST_LOGIT_TOL
            err = within(kern, plain)
            check(err <= tol, f"GAT {mode}: kernel-path logits differ from the "
                  f"plain path's by {err:.3g} of the largest logit (> {tol})")
            stages = {k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in st.items()}
            log(f"[serve-gat] {mode} request: {wall:.3f} s  launches={counts}  "
                f"labels={sorted(labels)}  logits vs plain path {err:.3g} of "
                f"the largest  stages={json.dumps(stages)}  card: {card}")
    return {"launches": total}


def label_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of voxels matching after mapping each a-label to its
    majority b-label (the smallest on a tie): `_agreement` of
    tests/test_slic_tpu.py, computed from the sorted label pairs instead of
    a dense confusion matrix, which would not fit at BraTS size."""
    a, b = a.ravel().astype(np.int64), b.ravel().astype(np.int64)
    nb = int(b.max()) + 1
    pairs, counts = np.unique(a * nb + b, return_counts=True)
    pa, pb = pairs // nb, pairs % nb
    order = np.lexsort((pb, -counts, pa))
    first = np.ones(len(order), bool)
    first[1:] = pa[order][1:] != pa[order][:-1]
    best = np.full(int(a.max()) + 1, -1, np.int64)
    best[pa[order][first]] = pb[order][first]
    return float(np.mean(best[a] == b))


CHAIN_SMOOTH_TOL = 2e-5
CHAIN_SLIC_AGREEMENT = 0.98


def check_chain(in_dir, device, card, num_nodes=NUM_NODES) -> dict:
    """The device chain (ops/slic_device.serve_preprocess_device) on the
    brain's crop, held to the host: q and the standardized volume bitwise
    (exact mode), one fast-mode call on a non-integral copy (+0.25) held to
    the quantile of its bfloat16-rounded values, gauss_smooth within
    CHAIN_SMOOTH_TOL of scipy, the raw SLIC labels in >= CHAIN_SLIC_AGREEMENT
    of the voxels like the host canonical's (native, on the same
    standardized volume), two runs bitwise equal, every tensor on
    `device`."""
    from scipy import ndimage

    from gnn_tumor_seg_tpu_torch.config import (DEFAULT_MODALITY_EXTS,
                                                STANDARDIZATION_STATS)
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.data.image import (_fast_quantile_per_channel,
                                                    determine_brain_crop,
                                                    normalize_img, standardize_img)
    from gnn_tumor_seg_tpu_torch.data.slic import slic_supervoxels
    from gnn_tumor_seg_tpu_torch.ops import slic_device

    image = nifti.read_in_patient_sample(in_dir, DEFAULT_MODALITY_EXTS)
    crop = np.ascontiguousarray(image[determine_brain_crop(image)])
    mean, std = (np.asarray(v, np.float32) for v in STANDARDIZATION_STATS)
    runs = [slic_device.serve_preprocess_device(crop, num_nodes, 0.5, mean, std,
                                                device=device) for _ in range(2)]
    (labels, vol, q, step), (labels2, vol2, q2, _) = runs
    check(vol.device.type == torch.device(device).type,
          f"the standardized volume is on {vol.device}")
    check(np.array_equal(q, _fast_quantile_per_channel(crop, 0.995)),
          f"device q {q} differs from the host's")
    host_std = standardize_img(normalize_img(crop), mean, std)
    got = vol.permute(1, 2, 3, 0).cpu().numpy()
    check(np.array_equal(got, host_std),
          f"standardized volume differs from the host's in "
          f"{int((got != host_std).sum())} values")
    check(np.array_equal(labels, labels2) and np.array_equal(q, q2)
          and torch.equal(vol, vol2), "two runs of the chain differ")
    off = crop + np.float32(0.25)
    _, _, qf, _ = slic_device.serve_preprocess_device(
        off, num_nodes, 0.5, mean, std, sigma=0.0, max_iter=0,
        input_dtype=torch.bfloat16, device=device)
    rounded = torch.from_numpy(off).to(torch.bfloat16).float().numpy()
    check(np.array_equal(qf, _fast_quantile_per_channel(rounded, 0.995)),
          f"fast-mode q {qf} is not the quantile of the bfloat16-rounded crop")
    smoothed = slic_device.gauss_smooth(vol, 1.0).permute(1, 2, 3, 0).cpu().numpy()
    want = np.stack([ndimage.gaussian_filter(host_std[..., c], 1.0)
                     for c in range(host_std.shape[-1])], -1)
    smooth_err = float(np.abs(smoothed - want).max())
    check(np.allclose(smoothed, want, rtol=CHAIN_SMOOTH_TOL, atol=CHAIN_SMOOTH_TOL),
          f"gauss_smooth differs from scipy by up to {smooth_err}")
    t = time.perf_counter()
    host = slic_supervoxels(host_std, n_segments=num_nodes, compactness=0.5,
                            enforce_connectivity=False, use_native=True)
    host_s = time.perf_counter() - t
    agree = label_agreement(labels, host)
    check(agree >= CHAIN_SLIC_AGREEMENT,
          f"device SLIC agrees with the host canonical in {agree} of the voxels")
    log(f"[deviceprep] chain on the crop {crop.shape}: q and standardized "
        f"volume bitwise the host's, fast-mode q of the bf16-rounded copy, "
        f"smoothing within {smooth_err:.3g} of scipy, raw labels agree "
        f"{agree:.6f} with host native SLIC ({host_s:.2f} s), "
        f"deterministic; card: {card}")
    return {"crop": crop, "q": q, "mean": mean, "std": std}


def profile_chain_parts(chain, device, card, num_nodes=NUM_NODES,
                        max_iter=10, sessions=3) -> dict:
    """The chain's device time by part, each with its launches: upload,
    order statistics, affine, smoothing, and the SLIC loop split by running
    slic_iterate at 0, 1 and 2 rounds (setup with the first centers; + one
    assignment pass; + an update and another pass), beside the whole loop
    at max_iter rounds. Each part runs inside its own record_function
    range under torch.profiler, which gives its device busy ms and
    launches: a kernel or copy belongs to the range of the operation that
    launched it (the profiler's correlation; by timestamps, events moved
    between parts from one run to the next). The profiler at times drops
    a part's events (most often the upload's copy and kernel, the first
    device work of a session), never adds any, so each part is taken from
    the session, of `sessions`, that recorded the most launches for it;
    beside it is logged its span on the stream between CUDA events, which
    also counts the host work between launches (the upload's int16 check
    and pinning, the fixed-point scale's read-back). The
    assignment pass's byte bound: the volume's C floats read and one int32
    id written per voxel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gnn_tumor_seg_tpu_torch.ops import slic_device

    crop = chain["crop"]
    X, Y, Z, C = crop.shape
    dev = torch.device(device)
    pos = (X * Y * Z - 1) * 0.995
    names = ["upload", "order statistics", "affine", "smoothing"] + [
        f"slic loop, {i} rounds" for i in (0, 1, 2, max_iter)]
    spans = {name: [] for name in names}

    def part(name, fn):
        with record_function(f"chain: {name}"):
            if dev.type != "cuda":
                return fn()
            ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ends[0].record()
            out = fn()
            ends[1].record()
            torch.cuda.synchronize()
            spans[name].append(ends[0].elapsed_time(ends[1]))
        return out

    def session():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            img = part(names[0], lambda: slic_device.upload(crop, dev))
            part(names[1], lambda: slic_device.order_stats(
                img, int(np.floor(pos)), int(np.ceil(pos))))
            vol = part(names[2], lambda: slic_device.affine(
                img, chain["q"], chain["mean"], chain["std"]))
            sm = part(names[3], lambda: slic_device.gauss_smooth(vol, 1.0))
            for name, rounds in zip(names[4:], (0, 1, 2, max_iter)):
                part(name, lambda r=rounds: slic_device.assign_core(
                    sm, num_nodes, 0.5, r))
        got = {name: (0.0, 0) for name in names}
        for e in prof.events():
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            owner = e
            while owner is not None and not owner.name.startswith("chain: "):
                owner = owner.cpu_parent
            if owner is not None:
                ms, n = got[owner.name[len("chain: "):]]
                got[owner.name[len("chain: "):]] = (
                    ms + sum(k.duration for k in e.kernels) / 1e3, n + len(e.kernels))
        return got

    runs = [session() for _ in range(sessions)]
    got = {n: max((r[n] for r in runs), key=lambda v: v[1]) for n in names}
    log(f"[deviceprep] launches recorded by part in {sessions} profiler "
        f"sessions: " + json.dumps({n: [r[n][1] for r in runs] for n in names}))
    log("[deviceprep] stream span by part (CUDA events, ms, each session): "
        + json.dumps({n: [round(v, 4) for v in spans[n]] for n in names}))
    missing = [n for n in names if got[n][1] == 0]
    if missing:
        log(f"[deviceprep] the profiler recorded no launch of {missing} in "
            f"any session; their spans stand for them")
    loop = [tuple(got[n]) for n in names[4:]]
    setup = loop[0]
    assign = tuple(b - a for a, b in zip(loop[0], loop[1]))
    update = tuple(c - 2 * b + a for a, b, c in zip(loop[0], loop[1], loop[2]))
    parts = {**{n: tuple(got[n]) for n in names[:4]},
             "slic setup and first centers": setup,
             f"assignment passes (x{max_iter})": tuple(max_iter * v for v in assign),
             f"update passes (x{max_iter - 1})": tuple((max_iter - 1) * v
                                                       for v in update)}
    total = sum(ms for ms, _ in parts.values())
    bound_ms = X * Y * Z * (4 * C + 4) / HBM_BYTES_PER_S * 1e3
    for name, (ms, n) in parts.items():
        log(f"[deviceprep] device time {name}: {ms:.3f} ms, {n} launches")
    log(f"[deviceprep] chain device time {total:.3f} ms; the SLIC loop at "
        f"{max_iter} rounds measured whole {loop[3][0]:.3f} ms, {loop[3][1]} "
        f"launches; one assignment pass {assign[0]:.3f} ms, {assign[1]} "
        f"launches, byte bound {bound_ms:.4f} ms ({X * Y * Z} voxels x "
        f"({C} floats + 1 int32)); one update pass {update[0]:.3f} ms, "
        f"{update[1]} launches; card: {card}")
    return {"parts": parts, "total_ms": total, "assign_pass_ms": assign[0],
            "assign_bound_ms": bound_ms}


def phase_serve_deviceprep(device, inputs, card="", num_nodes=NUM_NODES,
                           requests=REQUESTS_PER_MODE, shape=BRAIN_SHAPE,
                           host_run=None) -> dict:
    """The cell serve-1mri-deviceprep: serve-1mri's brain and models through
    predict_single_mri(prep_impl="device"), `requests` requests in "exact"
    and as many in "fast" (7 max_agg launches each, nothing else), then one
    GAT request in "exact" (5 gat_fwd launches); the chain held to the host
    (check_chain); one exact request through --slic_impl tpu (host
    normalization, SLIC on the card); on the card also the chain's device
    time by part, a profiled device-prep request beside phase 4's profiled
    host-prep one, `host_run` (busy, idle share and the final labels they
    share), and one `python -m gnn_tumor_seg_tpu_torch.cli.warmup
    --slic_impl tpu` in its own process. Returns the launches by kernel."""
    from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                    load_gnn_from_checkpoint,
                                                    resolve_slic_fn)
    from gnn_tumor_seg_tpu_torch.cli.predict_single import predict_single_mri
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    on_card = torch.device(device).type == "cuda"
    in_dir, gnn_ckpt, cnn_ckpt = inputs
    gnn, _, gnn_forward = load_gnn_from_checkpoint(gnn_ckpt, device=device)
    gat, _, gat_forward = load_gnn_from_checkpoint(gat_checkpoint(gnn_ckpt),
                                                   device=device)
    _, _, cnn_forward = load_cnn_from_checkpoint(cnn_ckpt, device=device)
    with precision_scope("exact"):
        chain = check_chain(in_dir, device, card, num_nodes)
    total = dict(NO_LAUNCHES)

    def request(label, forward, want, **kw):
        st = {}
        read = _reset_counts()
        t = time.perf_counter()
        pred = predict_single_mri(in_dir, forward, cnn_forward,
                                  num_nodes=num_nodes, stage_times=st, **kw)
        wall = time.perf_counter() - t
        counts = read()
        for k, n in counts.items():
            total[k] += n
        if on_card:
            check(counts == {**NO_LAUNCHES, **want},
                  f"{label}: kernel launches {counts}, expected {want}")
        labels = set(np.unique(pred).tolist())
        check(pred.shape == tuple(shape) and pred.dtype == np.int16,
              f"{label}: prediction {pred.shape} {pred.dtype}")
        check(labels <= {0, 1, 2, 4}, f"{label}: labels {labels}")
        stages = {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in st.items()}
        log(f"[deviceprep] {label}: {wall:.3f} s  launches={counts}  "
            f"labels={sorted(labels)}  stages={json.dumps(stages)}  card: {card}")
        return pred

    gspool = {"max_agg": gnn.num_layers}
    for mode in ("exact", "fast"):
        with precision_scope(mode):
            for r in range(requests):
                pred = request(f"{mode} request {r}", gnn_forward, gspool,
                               prep_impl="device", device=device)
                if mode == "exact":
                    exact_pred = pred
    with precision_scope("exact"):
        request("GAT exact request", gat_forward, {"gat_fwd": gat.num_layers},
                prep_impl="device", device=device)
        request("exact request, --slic_impl tpu", gnn_forward, gspool,
                slic_fn=resolve_slic_fn("tpu", device=device))
    result = {"launches": total}
    if not on_card:
        return result
    with precision_scope("exact"):
        result["chain"] = profile_chain_parts(chain, device, card, num_nodes)
        dev_run = profile_request(lambda: predict_single_mri(
            in_dir, gnn_forward, cnn_forward, num_nodes=num_nodes,
            prep_impl="device", device=device), gnn.num_layers, card,
            "device-prep exact request")
    log(f"[deviceprep] host-prep exact request (phase 4): wall "
        f"{host_run['wall_ms']:.1f} ms, device busy {host_run['busy_ms']:.3f} ms, "
        f"idle share {host_run['idle_share']:.6f}; card: {card}")
    check(np.array_equal(dev_run["result"], exact_pred),
          "the profiled device-prep request's labels differ from the first's")
    shared = int((dev_run["result"] == host_run["result"]).sum())
    log(f"[deviceprep] final labels shared by the device-prep and host-prep "
        f"requests: {shared} of {exact_pred.size} voxels "
        f"({shared / exact_pred.size:.6f}); card: {card}")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gnn_tumor_seg_tpu_torch.cli.warmup", "-g", gnn_ckpt,
         "-c", cnn_ckpt, "--slic_impl", "tpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    warm_s = time.perf_counter() - t
    check(proc.returncode == 0, f"cli.warmup failed:\n{proc.stdout}\n{proc.stderr}")
    for line in proc.stdout.strip().splitlines():
        log(f"[deviceprep] warmup: {line}")
    log(f"[deviceprep] cli.warmup process: {warm_s:.2f} s; card: {card}")
    result.update(device_prep=dev_run, host_prep=host_run, shared=shared,
                  warmup_s=warm_s)
    return result


def phase_preprocess_device(tmp: str, card: str, host_s: float, device="cuda",
                            num_nodes=NUM_NODES) -> dict:
    """Bulk device preprocessing on the two brains of
    preprocess-weighted-2mri (after phase_preprocess_weighted, whose host
    store it reads): cli.preprocess --prep_impl device --weighted, and the
    host path with --slic_impl tpu. The device store's inputs must be
    bitwise the host store's; its partitions, edges and labels those of
    the --slic_impl tpu store, its features within CHAIN_SMOOTH_TOL."""
    from gnn_tumor_seg_tpu_torch.cli import preprocess
    from gnn_tumor_seg_tpu_torch.data import nifti, store
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope

    raw = os.path.join(tmp, "raw")
    args = ["-d", raw, "--weighted", "-n", str(num_nodes), "-k", "10", "-l",
            "_seg.nii.gz", "--device", device]
    secs = {}
    with precision_scope("exact"):
        for name, flags in (("device", ["--prep_impl", "device"]),
                            ("tpu", ["--slic_impl", "tpu", "--prep_impl", "host"])):
            t = time.perf_counter()
            preprocess.main([*args, "-o", os.path.join(tmp, f"{name}_store"), *flags])
            secs[name] = time.perf_counter() - t
    ids = sorted(os.listdir(os.path.join(tmp, "device_store")))
    check(ids == ["BraTS_000", "BraTS_001"], f"device-prep samples {ids}")
    for mri_id in ids:
        def path(st, suffix):
            return os.path.join(tmp, st, mri_id, f"{mri_id}{suffix}")

        check(np.array_equal(nifti.read_nifti(path("device_store", "_input.nii.gz")),
                             nifti.read_nifti(path("weighted_store", "_input.nii.gz"))),
              f"{mri_id}: device-prep input differs from the host path's")
        check(np.array_equal(
            nifti.read_nifti(path("device_store", "_supervoxels.nii.gz")),
            nifti.read_nifti(path("tpu_store", "_supervoxels.nii.gz"))),
            f"{mri_id}: device-prep partition differs from --slic_impl tpu's")
        a = store.load_graph_npz(path("device_store", "_graph.npz"))
        b = store.load_graph_npz(path("tpu_store", "_graph.npz"))
        check(np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
              and np.array_equal(a.labels, b.labels),
              f"{mri_id}: device-prep edges or labels differ from --slic_impl tpu's")
        check(np.allclose(a.feats, b.feats, atol=CHAIN_SMOOTH_TOL, rtol=0),
              f"{mri_id}: features differ by {np.abs(a.feats - b.feats).max()}")
    log(f"[preprocess] 2 brains: host {host_s:.2f} s, --prep_impl device "
        f"{secs['device']:.2f} s, --slic_impl tpu {secs['tpu']:.2f} s; inputs "
        f"bitwise the host's, partitions, edges and labels those of --slic_impl "
        f"tpu; card: {card}")
    return {"host_s": host_s, **{f"{k}_s": v for k, v in secs.items()}}


def profile_request(run, n_layers: int, card: str,
                    label: str = "exact request") -> dict:
    """One more request under torch.profiler: device busy time (the sum of
    kernel and copy time on the card; one stream, so they do not overlap)
    against the request's wall time, and the kernels that take it. Returns
    the kernel launches counted in the request, the request's result, its
    wall and busy ms and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import max_aggregate

    max_aggregate.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    launches = max_aggregate.launches
    check(launches == n_layers, f"profiled {label}: {launches} kernel launches")

    on_device = device_events(prof)
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3
    idle = (1 - busy_ms / wall_ms) if busy_ms else float("nan")
    log(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.6f}; card: {card}")
    for e in on_device[:12]:
        log(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return {"launches": launches, "result": out, "wall_ms": wall_ms,
            "busy_ms": busy_ms, "idle_share": idle}


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_eager(fn, reps: int = 20, inner: int = 20) -> float:
    """Median ms of one eager call, host work included: CUDA events around
    `inner` back-to-back calls, `reps` times, after a warm-up. For a kernel
    this short the wrapper's Python and the launch dominate."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_device(fn, reps: int = 10, inner: int = 20) -> float:
    """Median device ms of one call: `inner` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events, so no host work is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


def library_max_inputs(h, nbr, mask):
    """Inputs of F.embedding_bag(mode="max") for the serve variant's function
    (B=1): padded slots name an extra zero row passed as padding_idx, so they
    are left out of the max and a row with no real slot gives 0. The library
    call is a yardstick only; the port never makes it."""
    N, F = h.shape[1], h.shape[2]
    idx = torch.where(mask > 0, nbr, N)[0].contiguous()
    weight = torch.cat([h[0], h.new_zeros(1, F)])
    return idx, weight, N


def phase_timing(graph, card: str) -> dict:
    """On the served graph's own table: the kernel held bitwise against its
    plain version (with and without the arg store), then timed beside the
    plain version, the library call that computes the serve variant's
    function (F.embedding_bag, mode "max") and the byte bound. h is not
    flushed from L2: on the serve path it is the output of the matmul just
    before, so the kernel finds it there. These launches come after the
    serve phase's counts were read and are not part of them."""
    import torch.nn.functional as F_

    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_plain)

    dev = torch.device("cuda")
    nbr = graph.nbr.to(dev)
    mask = graph.nbr_mask.to(dev)
    B, N, D = nbr.shape
    check(B == 1, f"served batch {B}, expected 1")
    referenced = int(torch.unique(nbr[mask > 0]).numel())
    per_layer_widths = [IN_FEATS, *GNN_WIDTHS]   # the max runs at each layer's input width
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        tot = {"ms": 0.0, "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        for F in sorted(set(per_layer_widths)):
            count = per_layer_widths.count(F)
            h = torch.relu(torch.randn((B, N, F), generator=gen, device=dev)).to(dtype)
            idx, weight, pad = library_max_inputs(h, nbr, mask)
            library = lambda: F_.embedding_bag(idx, weight, mode="max",
                                               padding_idx=pad)
            want_out, want_arg = max_aggregate_plain(h, nbr, mask)
            out, arg = max_aggregate(h, nbr, mask, with_arg=True)
            out_serve, _ = max_aggregate(h, nbr, mask, with_arg=False)
            lib_out = library()
            torch.cuda.synchronize()
            tag = f"served N={N} D={D} F={F} {name}"
            worst = max(worst, (out.float() - want_out.float()).abs().max().item(),
                        (out_serve.float() - want_out.float()).abs().max().item())
            check(torch.equal(_bits(out), _bits(want_out))
                  and torch.equal(arg, want_arg),
                  f"kernel (arg stored) differs from plain ({tag})")
            check(torch.equal(_bits(out_serve), _bits(want_out)),
                  f"kernel (arg skipped) differs from plain ({tag})")
            check(torch.equal(_bits(lib_out), _bits(want_out[0])),
                  f"embedding_bag max differs from plain ({tag})")
            log(f"[kernel] bitwise equal: {tag}, arg stored and skipped; "
                f"embedding_bag max equal too")
            serve = lambda: max_aggregate(h, nbr, mask, with_arg=False)
            k_ms = time_device(serve)
            a_ms = time_device(lambda: max_aggregate(h, nbr, mask, with_arg=True))
            e_ms = time_eager(serve)
            p_ms = time_device(lambda: max_aggregate_plain(h, nbr, mask), inner=5)
            l_ms = time_device(library)
            # compulsory bytes: referenced rows of h once, nbr and mask, out
            nbytes = referenced * F * es + N * D * (4 + 4) + N * F * es
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            bound_arg = (nbytes + N * F) / HBM_BYTES_PER_S * 1e3
            log(f"[timing] max_agg {name} N={N} D={D} F={F} (x{count}/request): "
                f"device {k_ms:.5f} ms (bound {bound:.5f}, {nbytes} B), with arg "
                f"store {a_ms:.5f} ms (bound {bound_arg:.5f}), eager call "
                f"{e_ms:.5f} ms, plain {p_ms:.5f} ms, library (embedding_bag "
                f"max) {l_ms:.5f} ms; card: {card}")
            tot["ms"] += count * k_ms
            tot["eager_ms"] += count * e_ms
            tot["plain_ms"] += count * p_ms
            tot["library_ms"] += count * l_ms
            tot["bound_ms"] += count * bound
        rows[name] = tot
        log(f"[timing] max_agg per request {name}: {json.dumps(tot)}")
    return {"rows": rows, "N": N, "D": D, "referenced_rows": referenced,
            "max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------


def flagship_sample(rng, n_nodes, k=TRAIN_K, f_dim=IN_FEATS):
    """One graph of the training cell: the ring-shaped kNN structure of
    __graft_entry__.py:28-45 (each node linked to its k/2 successors, both
    directions stored; copied, since that module imports JAX), with labels
    on four arcs of the ring and features drawn around per-class means, so
    a falling loss means the model learns something."""
    half = k // 2
    base = np.arange(n_nodes)
    src = np.concatenate([(base + o) % n_nodes for o in range(1, half + 1)])
    dst = np.tile(base, half)
    cuts = np.sort(rng.choice(np.arange(1, n_nodes), 3, replace=False))
    labels = rng.permutation(4)[np.searchsorted(cuts, base, side="right")]
    class_means = rng.normal(0, 1.0, (4, f_dim))
    feats = (class_means[labels] + rng.normal(0, 1.0, (n_nodes, f_dim)))
    return (feats.astype(np.float32), np.concatenate([src, dst]),
            np.concatenate([dst, src]), labels.astype(np.int32))


def write_train_data(root: str, n_samples: int = TRAIN_BATCH,
                     weighted: bool = False) -> None:
    """A preprocessed data directory of the training cell: per sample the
    graph (.npz) and a small supervoxel and label volume (one voxel per node
    plus a background margin), so that evaluate runs. `weighted` attaches
    the intensity edge weights of data/graph_build (sigma 0.1), as
    cli.preprocess --weighted does."""
    from gnn_tumor_seg_tpu_torch.data import nifti, store
    from gnn_tumor_seg_tpu_torch.data.graph_build import (GraphSample,
                                                          intensity_edge_weights)
    from gnn_tumor_seg_tpu_torch.data.image import project_nodes_to_img

    rng = np.random.default_rng(SEED)
    vol_shape = (24, 24, 16)          # 9216 voxels >= 7000 nodes
    for i in range(n_samples):
        feats, src, dst, labels = flagship_sample(rng, TRAIN_NODES)
        mri_id = f"train_{i:03d}"
        d = os.path.join(root, mri_id)
        os.makedirs(d)
        store.save_graph_npz(os.path.join(d, f"{mri_id}_graph.npz"), GraphSample(
            feats=feats, labels=labels, centroids=np.zeros((len(feats), 3)),
            src=src, dst=dst, sv_partition=None,
            edge_weights=(intensity_edge_weights(feats, src, dst, sigma=0.1)
                          if weighted else None)))
        sv = np.arange(np.prod(vol_shape)).reshape(vol_shape)
        sv = np.where(sv < len(feats), sv, -1).astype(np.int16)
        nifti.save_as_nifti(sv, os.path.join(d, f"{mri_id}_supervoxels.nii.gz"))
        nifti.save_as_nifti(project_nodes_to_img(sv, labels).astype(np.int16),
                            os.path.join(d, f"{mri_id}_label.nii.gz"))


NO_LAUNCHES = {k: 0 for k in ("max_agg", "max_agg_bwd", "sum_agg", "gat_fwd",
                               "gat_bwd", "gat_rev", "wsum", "wsum_bwd",
                               "pairdot", "slot_gather", "slot_gather_bwd")}


def _reset_counts():
    """Set every kernel's launch count to 0; returns a function that reads
    them."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import (
        fused_gat_backward, fused_gat_forward, gat_reverse_combine)
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_backward)
    from gnn_tumor_seg_tpu_torch.ops.kernels.slot_gather import (
        slot_gather, slot_gather_backward)
    from gnn_tumor_seg_tpu_torch.ops.kernels.sum_agg import sum_aggregate
    from gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum import (
        pairdot, weighted_sum, weighted_sum_reverse)

    fns = {"max_agg": max_aggregate, "max_agg_bwd": max_aggregate_backward,
           "sum_agg": sum_aggregate, "gat_fwd": fused_gat_forward,
           "gat_bwd": fused_gat_backward, "gat_rev": gat_reverse_combine,
           "wsum": weighted_sum, "wsum_bwd": weighted_sum_reverse,
           "pairdot": pairdot, "slot_gather": slot_gather,
           "slot_gather_bwd": slot_gather_backward}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def train_cli_run(data_dir, out_dir, run, model_type, n_epochs, precision,
                  card, device="cuda", weighted=False) -> dict:
    """One run of cli.train_gnn.main (-k 1), with every kernel count set to
    0 just before it and read just after. On the card, checks the per-step
    launches (`weighted`: the data directory carries edge weights); returns
    the epochs' log records and the counts. On the CPU (a rehearsal) no
    kernel is launched."""
    from gnn_tumor_seg_tpu_torch.cli import train_gnn

    hp = _train_hp(model_type)
    layers = len(hp.layer_sizes) + 1
    argv = ["-d", data_dir, "-o", out_dir, "-r", run, "-m", model_type, "-k", "1",
            "--hp", f"layer_sizes={hp.layer_sizes}", "--hp", f"n_epochs={n_epochs}",
            "--device", device]
    old = os.environ.get("GTS_PALLAS_PRECISION")
    os.environ["GTS_PALLAS_PRECISION"] = precision
    try:
        read = _reset_counts()
        t = time.perf_counter()
        train_gnn.main(argv)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read()
    finally:
        if old is None:
            os.environ.pop("GTS_PALLAS_PRECISION")
        else:
            os.environ["GTS_PALLAS_PRECISION"] = old
    with open(os.path.join(out_dir, f"{run}.txt.jsonl")) as f:
        epochs = [json.loads(line) for line in f if '"epoch"' in line]
    steps = sum(e["steps"] for e in epochs)
    eval_batches = 1                  # 6 samples, batch 6
    want = dict(NO_LAUNCHES)
    if device != "cuda":
        pass                          # the plain versions launch nothing
    elif model_type == "GSpool":
        want.update(max_agg=layers * (steps + eval_batches),
                    max_agg_bwd=layers * steps)
    elif model_type == "GAT":
        # every layer's z needs a gradient (through w): 5 + 5 + 5 per step
        want.update(gat_fwd=layers * (steps + eval_batches),
                    gat_bwd=layers * steps, gat_rev=layers * steps)
    elif weighted:
        # the weighted combine: 7 forward + 6 reverse per step (the first
        # layer's input needs no gradient); the edge weights are data, so no
        # pair dot, and the kernel reads the reverse weights through rslot
        want.update(wsum=layers * (steps + eval_batches),
                    wsum_bwd=(layers - 1) * steps)
    else:
        # the first layer's input needs no gradient: 7 forward + 6 backward
        want.update(sum_agg=(2 * layers - 1) * steps + layers * eval_batches)
    check(counts == want, f"{run}: kernel launches {counts}, expected {want}")
    losses = [e["loss"] for e in epochs]
    check(all(np.isfinite(losses)), f"{run}: non-finite losses {losses}")
    impl = "cuda" if device == "cuda" else "plain"
    check(all(e["precision"] == precision and e["impl"] == impl for e in epochs),
          f"{run}: epochs ran as {[(e['precision'], e['impl']) for e in epochs]}")
    log(f"[train] {run}: {model_type} {precision}, {len(epochs)} epochs x "
        f"{epochs[0]['steps']} step(s), losses {losses}, launches {counts} "
        f"({steps} steps + {eval_batches} eval batch), edges_per_s "
        f"{[round(e['edges_per_s']) for e in epochs]}, wall {wall:.2f} s; "
        f"card: {card}")
    return {"epochs": epochs, "counts": counts, "steps": steps}


def grads_match_plain(dataset, model_type, card, device="cuda",
                      attn_drop=0.0) -> float:
    """One batch in exact mode: the parameter gradients through the kernels
    equal those through the plain versions, bitwise for the SAGE models (the
    kernels are bitwise equal to their plain versions and the rest is the
    same code); for GAT within GAT_GRAD_TOL of each tensor's largest entry
    (the fused forward and backward, and the pair dot, are held to a
    tolerance, not bitwise). Both runs draw their dropout from a generator
    seeded alike, so they share every keep-mask. Returns the largest
    relative difference."""
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
    from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

    hp = _train_hp(model_type)
    trainer = GNNTrainer(model_type, hp, dataset, seed=SEED, device=device)
    trainer.model.attn_drop = attn_drop
    batch = batch_graphs([dataset.get_graph(i) for i in range(len(dataset))]).to(device)
    params = trainer.model.jax_parameters()

    def grads():
        gen = torch.Generator(device=device).manual_seed(SEED)
        with precision_scope("exact"):
            logits = trainer.model(batch, train=True, generator=gen)
            loss = weighted_cross_entropy(logits, batch.labels,
                                          trainer.class_weights, batch.node_mask)
            return torch.autograd.grad(loss, params)

    kern = grads()
    with plain_aggregation():
        plain = grads()
    rel = max(within(a, b) for a, b in zip(kern, plain))
    name = model_type + (f" attn_drop={attn_drop}" if attn_drop else "")
    if batch.edge_weight is not None:
        name += " weighted"
    if model_type == "GAT":
        check(rel <= GAT_GRAD_TOL,
              f"{name}: parameter gradients through the kernels differ from "
              f"the plain path's by {rel:.3g} of a tensor's largest entry")
        how = f"within {rel:.3g} (tolerance {GAT_GRAD_TOL}) of"
    else:
        check(all(torch.equal(a, b) for a, b in zip(kern, plain)),
              f"{name}: parameter gradients through the kernels differ "
              f"from the plain aggregation's ({rel:.3g} relative)")
        how = "bitwise equal to"
    log(f"[train] {name} exact: parameter gradients through the kernels "
        f"{how} the plain path's ({len(params)} tensors); card: {card}")
    return rel


def _train_hp(model_type="GSpool"):
    """The training cell's configuration: GAT's hardcoded one, or the SAGE
    models at TRAIN_WIDTHS."""
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters

    hp = hardcoded_hyperparameters(model_type)
    if model_type != "GAT":
        hp.layer_sizes = list(TRAIN_WIDTHS)
    return hp


def phase_train(tmp: str, card: str, device="cuda") -> dict:
    """The training main path through cli.train_gnn on the card: GSpool
    [256]*6 and the hardcoded GAT for 3 epochs in "fast" each (the loss must
    fall) and 1 in "exact", GSmean and GSgcn for 1 epoch each; the GSpool
    and GAT checkpoints served through load_gnn_from_checkpoint; gradients
    through the kernels against the plain path's for the four models."""
    from gnn_tumor_seg_tpu_torch.cli.common import load_gnn_from_checkpoint
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset

    data_dir = os.path.join(tmp, "train_data")
    out_dir = os.path.join(tmp, "train_logs")
    t = time.perf_counter()
    write_train_data(data_dir)
    log(f"[train] wrote {TRAIN_BATCH} samples of {TRAIN_NODES} nodes in "
        f"{time.perf_counter() - t:.2f} s")
    plan = [("gspool_fast", "GSpool", 3, "fast"),
            ("gspool_exact", "GSpool", 1, "exact"),
            ("gsmean", "GSmean", 1, "fast"), ("gsgcn", "GSgcn", 1, "fast"),
            ("gat_fast", "GAT", 3, "fast"), ("gat_exact", "GAT", 1, "exact")]
    runs = {run: train_cli_run(data_dir, out_dir, run, model_type, epochs,
                               precision, card, device)
            for run, model_type, epochs, precision in plan}
    dataset = ImageGraphDataset(data_dir, read_image=False)
    graph = dataset.get_graph(0)
    for run, name, kernel in (("gspool_fast", "GSpool", "max_agg"),
                              ("gat_fast", "GAT", "gat_fwd")):
        losses = [e["loss"] for e in runs[run]["epochs"]]
        check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
        with open(os.path.join(out_dir, f"{run}.txt")) as f:
            rows = [line for line in f if line.startswith(f"{run}_full\t")]
        check(len(rows) == 1, f"no progress row for the {name} run")
        log(f"[train] progress row: {rows[0].strip()}")
        model, _, forward = load_gnn_from_checkpoint(
            os.path.join(out_dir, f"{run}_f1.ckpt"), device=device)
        read = _reset_counts()
        logits = forward(graph)
        if device == "cuda":
            torch.cuda.synchronize()
            check(read() == {**NO_LAUNCHES, kernel: model.num_layers},
                  f"served {name} checkpoint: {read()} launches")
        check(logits.shape == (1, graph.num_nodes_padded, 4)
              and bool(torch.isfinite(logits).all()),
              f"served {name} checkpoint logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        log(f"[train] {run}_f1.ckpt served through load_gnn_from_checkpoint: "
            f"finite logits {tuple(logits.shape)}, {model.num_layers} {kernel} "
            f"launches")
    grads = {model_type: grads_match_plain(dataset, model_type, card, device)
             for model_type in ("GSpool", "GSmean", "GSgcn", "GAT")}
    return {"runs": runs, "data_dir": data_dir, "gat_grad_rel": grads["GAT"]}


def write_brats_folder(root: str, shape=BRAIN_SHAPE, seeds=(0, 1)) -> None:
    """Synthetic labelled brains (make_brain, one seed each) as a BraTS
    folder: BraTS_<i>/BraTS_<i>_{flair,t1,t1ce,t2,seg}.nii.gz."""
    from gnn_tumor_seg_tpu_torch.data import nifti

    for i, seed in enumerate(seeds):
        mri_id = f"BraTS_{i:03d}"
        d = os.path.join(root, mri_id)
        os.makedirs(d)
        mods, labels = make_brain(np.random.default_rng(seed), shape)
        for name, vol in zip(("flair", "t1", "t1ce", "t2", "seg"), (*mods, labels)):
            nifti.save_as_nifti(vol, os.path.join(d, f"{mri_id}_{name}.nii.gz"))


def phase_preprocess_weighted(tmp: str, card: str, device="cuda",
                              shape=BRAIN_SHAPE, num_nodes=NUM_NODES) -> dict:
    """The cell preprocess-weighted-2mri: two synthetic brains through
    cli.preprocess --weighted (host), then one fast epoch of GSmean [256]*6
    on that store through cli.train_gnn. The store must hold edge weights;
    the run must launch wsum and wsum_bwd and never sum_agg, with a finite
    loss."""
    from gnn_tumor_seg_tpu_torch.cli import preprocess

    raw, store = os.path.join(tmp, "raw"), os.path.join(tmp, "weighted_store")
    t = time.perf_counter()
    write_brats_folder(raw, shape)
    log(f"[preprocess] wrote 2 brains {shape} in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    preprocess.main(["-d", raw, "-o", store, "--weighted", "-n", str(num_nodes),
                     "-k", "10", "-l", "_seg.nii.gz"])
    prep_s = time.perf_counter() - t
    ids = sorted(os.listdir(store))
    check(ids == ["BraTS_000", "BraTS_001"], f"preprocessed samples {ids}")
    sizes = []
    for mri_id in ids:
        with np.load(os.path.join(store, mri_id, f"{mri_id}_graph.npz")) as z:
            check("edge_weights" in z.files, f"{mri_id}: no edge_weights in the store")
            w = z["edge_weights"]
            check(len(w) == len(z["src"]) > 0 and bool(np.isfinite(w).all()),
                  f"{mri_id}: edge weights {w.shape}")
            sizes.append((len(z["feats"]), len(w)))
    log(f"[preprocess] cli.preprocess --weighted: {prep_s:.2f} s for 2 brains, "
        f"(nodes, edges) {sizes}; card: {card}")
    out_dir = os.path.join(tmp, "weighted_logs")
    run = train_cli_run(store, out_dir, "prep_gsmean", "GSmean", 1, "fast", card,
                        device, weighted=True)
    if device == "cuda":
        counts = run["counts"]
        check(counts["wsum"] > 0 and counts["wsum_bwd"] > 0
              and counts["sum_agg"] == 0, f"weighted store run: {counts}")
    return {"run": run, "preprocess_s": prep_s, "sizes": sizes}


def phase_train_weighted(tmp: str, card: str, device="cuda") -> dict:
    """The cell train-gsmean-weighted-b6: the 6 graphs of the training cell
    with intensity edge weights (sigma 0.1); GSmean and GSgcn [256]*6 through
    cli.train_gnn, 3 fast epochs (the loss must fall) and 1 exact each, with
    their launch counts checked per step; then the parameter gradients
    through the kernels on one exact batch, bitwise equal to the plain
    path's."""
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset

    data_dir = os.path.join(tmp, "train_weighted")
    out_dir = os.path.join(tmp, "train_weighted_logs")
    write_train_data(data_dir, weighted=True)
    plan = [("gsmean_w_fast", "GSmean", 3, "fast"),
            ("gsmean_w_exact", "GSmean", 1, "exact"),
            ("gsgcn_w_fast", "GSgcn", 3, "fast"),
            ("gsgcn_w_exact", "GSgcn", 1, "exact")]
    runs = {run: train_cli_run(data_dir, out_dir, run, model_type, epochs,
                               precision, card, device, weighted=True)
            for run, model_type, epochs, precision in plan}
    for run in ("gsmean_w_fast", "gsgcn_w_fast"):
        losses = [e["loss"] for e in runs[run]["epochs"]]
        check(losses[-1] < losses[0], f"{run}: loss did not fall: {losses}")
    dataset = ImageGraphDataset(data_dir, read_image=False)
    check(dataset.get_graph(0).edge_weight is not None, "weighted cell without "
          "edge weights")
    for model_type in ("GSmean", "GSgcn"):
        grads_match_plain(dataset, model_type, card, device)
    return {"runs": runs, "data_dir": data_dir}


GAT_ATTN_DROP = 0.1


def gat_dropout_run(dataset, n_epochs, precision, card, device="cuda") -> dict:
    """The hardcoded GAT with attention dropout GAT_ATTN_DROP trained through
    GNNTrainer.run_epoch (forward with train=True, weighted CE, backward,
    AdamW), with every kernel count set to 0 just before and read just
    after; on the card 5 slot_gather, 5 wsum, 5 wsum_bwd, 5 pairdot and 5
    slot_gather_bwd per step, and nothing else."""
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer

    trainer = GNNTrainer("GAT", _train_hp("GAT"), dataset, seed=SEED,
                         precision=precision, device=device)
    trainer.model.attn_drop = GAT_ATTN_DROP
    layers = trainer.model.num_layers
    read = _reset_counts()
    losses, steps = [], 0
    t = time.perf_counter()
    for _ in range(n_epochs):
        losses.append(trainer.run_epoch())
        steps += trainer.last_epoch_stats["steps"]
    wall = time.perf_counter() - t
    counts = read()
    want = dict(NO_LAUNCHES)
    if device == "cuda":
        want.update({k: layers * steps for k in ("slot_gather", "wsum", "wsum_bwd",
                                                 "pairdot", "slot_gather_bwd")})
    check(counts == want, f"GAT attn_drop {precision}: launches {counts}, "
          f"expected {want}")
    check(all(np.isfinite(losses)), f"GAT attn_drop: non-finite losses {losses}")
    log(f"[train] GAT attn_drop={GAT_ATTN_DROP} {precision}: {n_epochs} epochs x "
        f"1 step, losses {losses}, launches {counts}, wall {wall:.2f} s; "
        f"card: {card}")
    return {"losses": losses, "counts": counts, "steps": steps}


def phase_train_gat_dropout(dataset, card, device="cuda") -> dict:
    """The cell train-gat-attndrop-b6: 3 fast epochs (the loss must fall)
    and 1 exact, then the gradient check against the plain path."""
    fast = gat_dropout_run(dataset, 3, "fast", card, device)
    check(fast["losses"][-1] < fast["losses"][0],
          f"GAT attn_drop loss did not fall: {fast['losses']}")
    exact = gat_dropout_run(dataset, 1, "exact", card, device)
    rel = grads_match_plain(dataset, "GAT", card, device, attn_drop=GAT_ATTN_DROP)
    return {"runs": {"gat_drop_fast": fast, "gat_drop_exact": exact},
            "grad_rel": rel}


# ---------------------------------------------------------------------------
# phase 7: training timing
# ---------------------------------------------------------------------------


def profile_train_steps(trainer, card, steps: int = 3) -> dict:
    """`steps` more epochs (one step each) under torch.profiler: the
    device's busy time and idle share over their wall time, and the top
    device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            trainer.run_epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    on_device = device_events(prof)
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    idle = 1 - busy_ms / wall_ms
    log(f"[train-profile] {steps} {trainer.precision} steps: wall {wall_ms:.3f} "
        f"ms, device busy {busy_ms:.3f} ms, idle share {idle:.6f}; card: {card}")
    top = []
    for e in on_device[:15]:
        log(f"[train-profile]   {_device_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")
        top.append([e.key[:60], round(_device_us(e) / 1e3, 4), e.count])
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": idle, "top": top}


def time_train_steps(dataset, card, model_type="GSpool", steps: int = 8,
                     attn_drop: float = 0.0) -> dict:
    """A training step of a cell (GSpool [256]*6, GSmean [256]*6 on the
    unweighted or the weighted dataset, or the hardcoded GAT, with attention
    dropout when `attn_drop`; batch 6 x 8192) through GNNTrainer.run_epoch,
    one step per epoch, in "exact" and "fast": the median epoch wall time (host clock,
    ending in the epoch's one synchronize) after 2 warm-up epochs, and
    edges_per_s (real edges x layers / step time, bench.py:160-161); then 3
    more steps under the profiler for the idle share and the top kernels."""
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer

    name = model_type + (f" attn_drop={attn_drop}" if attn_drop else "")
    if dataset.get_graph(0).edge_weight is not None:
        name += " weighted"
    out = {}
    for precision in ("exact", "fast"):
        trainer = GNNTrainer(model_type, _train_hp(model_type), dataset,
                             seed=SEED, precision=precision, device="cuda")
        trainer.model.attn_drop = attn_drop
        for _ in range(2):
            trainer.run_epoch()
        secs, eps = [], []
        for _ in range(steps):
            trainer.run_epoch()
            secs.append(trainer.last_epoch_stats["seconds"])
            eps.append(trainer.last_epoch_stats["edges_per_s"])
        out[precision] = {"step_ms": statistics.median(secs) * 1e3,
                          "edges_per_s": statistics.median(eps),
                          "step_ms_all": [round(x * 1e3, 3) for x in secs]}
        log(f"[train-timing] {name} {precision} step: median "
            f"{out[precision]['step_ms']:.3f} ms over {steps} steps "
            f"{out[precision]['step_ms_all']}, edges_per_s "
            f"{out[precision]['edges_per_s']:.6g}; card: {card}")
        out[precision]["profile"] = profile_train_steps(trainer, card)
        del trainer
    return out


def library_bag_inputs(h, nbr, mask):
    """Inputs of F.embedding_bag for the batched table: rows of all graphs
    stacked, padded slots naming an extra zero row passed as padding_idx
    (left out of the reduction; a bag of padding alone gives 0). A
    yardstick only; the port never calls it."""
    B, N, F = h.shape
    offs = (torch.arange(B, device=h.device) * N).view(B, 1, 1)
    idx = torch.where(mask > 0, nbr + offs, B * N).reshape(B * N, -1).contiguous()
    weight = torch.cat([h.reshape(B * N, F), h.new_zeros(1, F)])
    return idx, weight, B * N


def phase_train_timing(dataset, card) -> dict:
    """Per kernel at the flagship batch's own table (B=6, N=8192, D=12,
    F=20 and 256, and phase 10's TP_WIDTHS, f32 and bf16): device ms per
    launch (CUDA-graph replay),
    the plain version's, the library yardstick's and the byte bound, plus
    the train step. These launches come after the main path's counts were
    read and are not part of them."""
    import torch.nn.functional as F_

    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_backward, max_aggregate_backward_plain,
        max_aggregate_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.sum_agg import (
        sum_aggregate, sum_aggregate_plain)

    dev = torch.device("cuda")
    batch = batch_graphs([dataset.get_graph(i) for i in range(len(dataset))]).to(dev)
    nbr, mask, rslot = batch.nbr, batch.nbr_mask, batch.rslot
    B, N, D = nbr.shape
    offs = (torch.arange(B, device=dev) * N).view(B, 1, 1)
    referenced = int(torch.unique((nbr + offs)[mask > 0]).numel())
    table_bytes = B * N * D * 4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        for F in (IN_FEATS, TRAIN_WIDTHS[0], *TP_WIDTHS):
            shape = (B, N, F)
            h = torch.relu(torch.randn(shape, generator=gen, device=dev)).to(dtype)
            gout = torch.randn(shape, generator=gen, device=dev).to(dtype)
            out, arg = max_aggregate(h, nbr, mask, with_arg=True)
            grad = max_aggregate_backward(gout, arg, nbr, mask, rslot)
            sums = {m: sum_aggregate(h, nbr, mask, m) for m in (False, True)}
            idx, weight, pad = library_bag_inputs(h, nbr, mask)
            ebag = torch.ops.aten._embedding_bag.default
            offsets = torch.arange(0, idx.numel(), D, device=dev)
            flat = idx.reshape(-1)
            lib_out, offset2bag, bag_size, max_idx = ebag(
                weight, flat, offsets, False, 2, False, None, False, pad)
            # PyTorch has no bf16 max-mode embedding_bag backward on CUDA
            lib_bwd = None if dtype == torch.bfloat16 else (
                lambda: torch.ops.aten._embedding_bag_dense_backward.default(
                    gout.reshape(B * N, F), flat, offset2bag, bag_size, max_idx,
                    B * N + 1, False, 2, None, pad))
            lib_grad = None if lib_bwd is None else lib_bwd()
            torch.cuda.synchronize()
            tag = f"flagship batch B={B} N={N} D={D} F={F} {name}"
            check(torch.equal(_bits(out), _bits(max_aggregate_plain(h, nbr, mask)[0])),
                  f"max_agg differs from plain ({tag})")
            check(torch.equal(_bits(grad), _bits(max_aggregate_backward_plain(
                gout, arg, nbr, mask, rslot))), f"max_agg_bwd differs from plain ({tag})")
            for m, got in sums.items():
                check(torch.equal(_bits(got), _bits(sum_aggregate_plain(h, nbr, mask, m))),
                      f"sum_agg differs from plain ({tag}, mean={m})")
            check(torch.equal(_bits(lib_out), _bits(out.reshape(B * N, F))),
                  f"embedding_bag max differs from max_agg ({tag})")
            lib_err = 0.0 if lib_grad is None else (
                lib_grad[:B * N].float() - grad.reshape(B * N, F).float()
            ).abs().max().item()
            for m in (False, True):
                bag = F_.embedding_bag(idx, weight, mode="mean" if m else "sum",
                                       padding_idx=pad)
                lib_err = max(lib_err, (bag.float() - sums[m].reshape(B * N, F).float()
                                        ).abs().max().item())
            log(f"[kernel] bitwise equal to plain at the {tag}: max_agg, "
                f"max_agg_bwd, sum_agg; library results within {lib_err:.3g}")
            timings = {
                "max_agg": (lambda: max_aggregate(h, nbr, mask, with_arg=True),
                            lambda: max_aggregate_plain(h, nbr, mask),
                            lambda: ebag(weight, flat, offsets, False, 2, False,
                                         None, False, pad),
                            referenced * F * es + 2 * table_bytes
                            + B * N * F * (es + 1)),
                "max_agg_bwd": (
                    lambda: max_aggregate_backward(gout, arg, nbr, mask, rslot),
                    lambda: max_aggregate_backward_plain(gout, arg, nbr, mask, rslot),
                    lib_bwd,
                    referenced * F * (es + 1) + 3 * table_bytes + B * N * F * es),
                "sum_agg": (lambda: sum_aggregate(h, nbr, mask, False),
                            lambda: sum_aggregate_plain(h, nbr, mask, False),
                            lambda: F_.embedding_bag(idx, weight, mode="sum",
                                                     padding_idx=pad),
                            referenced * F * es + 2 * table_bytes + B * N * F * es),
                "sum_agg_mean": (lambda: sum_aggregate(h, nbr, mask, True),
                                 lambda: sum_aggregate_plain(h, nbr, mask, True),
                                 lambda: F_.embedding_bag(idx, weight, mode="mean",
                                                          padding_idx=pad),
                                 referenced * F * es + 2 * table_bytes
                                 + B * N * F * es),
            }
            for kname, (kern, plain, lib, nbytes) in timings.items():
                row = {"ms": time_device(kern), "plain_ms": time_device(plain, inner=5),
                       "library_ms": None if lib is None else time_device(lib),
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
                rows[(kname, name, F)] = row
                log(f"[train-timing] {kname} {name} F={F}: device "
                    f"{row['ms']:.5f} ms, bound {row['bound_ms']:.5f} ms "
                    f"({nbytes} B), plain {row['plain_ms']:.5f} ms, library "
                    f"{row['library_ms']} ms; card: {card}")
            del h, gout, out, arg, grad, sums, idx, weight, lib_out, lib_grad
    return {"rows": rows, "referenced_rows": referenced, "B": B, "N": N, "D": D}


def gat_library_inputs(z, alpha, nbr, mask):
    """Inputs of F.embedding_bag(mode="sum", per_sample_weights=alpha) over
    the [B*N*H, F] view of z: one bag per (row, head) of its D slots, padded
    slots naming an extra zero row passed as padding_idx. It computes the
    combine sum_d alpha z[nbr] alone (no softmax, no epilogue): a partial
    yardstick, which the port never calls."""
    B, N, H, F = z.shape
    D = nbr.shape[2]
    offs = (torch.arange(B, device=z.device) * N).view(B, 1, 1)
    rows = torch.where(mask > 0, nbr + offs, B * N)                 # [B,N,D]
    heads = torch.arange(H, device=z.device).view(1, 1, 1, H)
    idx = torch.where(rows[..., None] < B * N, rows[..., None] * H + heads,
                      B * N * H)                                     # [B,N,D,H]
    idx = idx.permute(0, 1, 3, 2).reshape(B * N * H, D).contiguous()
    w = alpha.reshape(B, N, D, H).permute(0, 1, 3, 2).reshape(B * N * H, D)
    weight = torch.cat([z.reshape(B * N * H, F), z.new_zeros(1, F)])
    return idx, weight, w.to(z.dtype).contiguous(), B * N * H


def phase_gat_timing(dataset, card) -> dict:
    """The three fused GAT kernels at the training batch's own table (B=6,
    N=8192, D=12) and the hardcoded GAT's layer shapes, with phase 10's
    head-parallel (2, 256), f32 and bf16:
    device ms per launch (CUDA-graph replay) of the forward as training runs
    it (alpha and sign mask stored) and as serving runs it, the backward and
    the reverse combine; each beside its plain version and its byte bound.
    Partial yardsticks in f32, none of which the port calls: for the
    forward, embedding_bag's weighted sum (the combine alone); for the
    backward, embedding_bag's per-sample-weight backward over alpha's bags
    (d_alpha alone, no softmax backward); for the reverse combine, its
    weight backward over the same bags (d_z alone, no d_el). These launches
    come after the main path's counts were read and are not part of them."""
    import torch.nn.functional as F_

    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import (
        fused_gat_backward, fused_gat_backward_plain, fused_gat_forward,
        fused_gat_forward_plain, gat_reverse_combine, gat_reverse_combine_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum import pairdot

    dev = torch.device("cuda")
    batch = batch_graphs([dataset.get_graph(i) for i in range(len(dataset))]).to(dev)
    nbr, mask, rslot = batch.nbr, batch.nbr_mask, batch.rslot
    B, N, D = nbr.shape
    offs = (torch.arange(B, device=dev) * N).view(B, 1, 1)
    referenced = int(torch.unique((nbr + offs)[mask > 0]).numel())
    # rows with a real slot: the backward reads gout only there (d_alpha
    # is 0 on the others)
    live_rows = int((mask > 0).any(dim=2).sum())
    layers = gat_layers()
    timed_layers = layers + TP_GAT_LAYERS[:1]      # and phase 10's (2, 256)
    rng = np.random.default_rng(SEED + 3)
    aten = torch.ops.aten
    rows = {}
    lib_what = {"gat_fwd": "embedding_bag weighted sum",
                "gat_bwd": "_embedding_bag_per_sample_weights_backward",
                "gat_rev": "_embedding_bag_dense_backward"}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        for H, F in gat_head_shapes(timed_layers):
            x = gat_inputs(rng, B, N, H, F, dtype, dev)
            z, gout = x["z"], x["gout"]
            HF, DH = H * F, D * H
            _, alpha, pos = fused_gat_forward(z, x["el"], x["er"], nbr, mask, 0.2,
                                              None, None, x["bias"], save=True)
            d_pre, _ = fused_gat_backward(gout, z, alpha, pos, nbr, mask)
            lib_ms = {k: None for k in lib_what}
            if dtype == torch.float32:
                idx, weight, w, pad = gat_library_inputs(z, alpha, nbr, mask)
                library = lambda: F_.embedding_bag(idx, weight, mode="sum",
                                                   per_sample_weights=w,
                                                   padding_idx=pad)
                combine, _, _ = fused_gat_forward(z, x["el"], x["er"], nbr, mask,
                                                  0.2, None, None,
                                                  torch.zeros_like(x["bias"]),
                                                  save=False)
                lib_err = within(library().reshape(B, N, H, F), combine)
                lib_ms["gat_fwd"] = time_device(library)
                # the bags of alpha over the [B*N*H, F] view of z
                flat, offsets, weight, pad = bag_library_inputs(z, nbr, mask)
                psw = alpha.reshape(B, N, D, H).permute(0, 1, 3, 2).reshape(-1)
                psw = psw.contiguous()
                _, o2b, bsz, mxi = aten._embedding_bag.default(
                    weight, flat, offsets, False, 0, False, psw, False, pad)
                g_flat = gout.reshape(B * N * H, F)
                d_alpha = lambda: (aten._embedding_bag_per_sample_weights_backward
                                   .default(g_flat, weight, flat, offsets, o2b, 0, pad))
                d_z = lambda: aten._embedding_bag_dense_backward.default(
                    g_flat, flat, o2b, bsz, mxi, pad + 1, False, 0, psw, pad)
                bwd_err = within(d_alpha().reshape(B, N, H, D).permute(0, 1, 3, 2),
                                 pairdot(gout, z, nbr, mask))
                rev_err = within(d_z()[:pad].reshape(B, N, H, F),
                                 gat_reverse_combine(gout, alpha, d_pre, nbr, mask,
                                                     rslot)[0])
                lib_ms["gat_bwd"] = time_device(d_alpha)
                lib_ms["gat_rev"] = time_device(d_z)
                log(f"[gat-timing] partial yardsticks at H={H} F={F} {name}, "
                    f"difference relative to the largest value: embedding_bag "
                    f"weighted sum vs the fused combine (no epilogue) {lib_err:.3g}; "
                    f"its per-sample-weight backward vs d_alpha (pairdot) "
                    f"{bwd_err:.3g}; its weight backward vs gat_rev's d_z "
                    f"{rev_err:.3g}")
                del idx, weight, w, combine, flat, offsets, psw, o2b, bsz, mxi
            table = B * N * D * 4
            slot = B * N * DH
            # compulsory bytes: each input read once (z's referenced rows),
            # each output written once
            ref_rows = referenced * HF * es
            fwd_in = ref_rows + 2 * B * N * H * es + 2 * table + HF * es
            timings = {}
            for act, with_res in sorted({(a, r) for h, f, a, r in timed_layers
                                         if (h, f) == (H, F)}, key=str):
                res = x["res"] if with_res else None
                args = (z, x["el"], x["er"], nbr, mask, 0.2, act, res, x["bias"])
                extra = B * N * HF * es if with_res else 0
                timings[("gat_fwd", act, with_res)] = (
                    lambda args=args: fused_gat_forward(*args, save=True),
                    lambda args=args: fused_gat_forward_plain(*args, save=True),
                    fwd_in + extra + B * N * HF * es + slot * 5)
                timings[("gat_fwd_serve", act, with_res)] = (
                    lambda args=args: fused_gat_forward(*args, save=False),
                    lambda args=args: fused_gat_forward_plain(*args, save=False),
                    fwd_in + extra + B * N * HF * es)
            timings[("gat_bwd", None, False)] = (
                lambda: fused_gat_backward(gout, z, alpha, pos, nbr, mask),
                lambda: fused_gat_backward_plain(gout, z, alpha, pos, nbr, mask),
                live_rows * HF * es + ref_rows + slot * 5 + 2 * table
                + slot * 4 + B * N * H * 4)
            timings[("gat_rev", None, False)] = (
                lambda: gat_reverse_combine(gout, alpha, d_pre, nbr, mask, rslot),
                lambda: gat_reverse_combine_plain(gout, alpha, d_pre, nbr, mask,
                                                  rslot),
                ref_rows + slot * 8 + 3 * table + B * N * HF * es + B * N * H * 4)
            for (kname, act, with_res), (kern, plain, nbytes) in timings.items():
                kind = kname.removesuffix("_serve")
                row = {"ms": time_device(kern), "plain_ms": time_device(plain, reps=5,
                                                                        inner=3),
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                       "library_ms": lib_ms[kind]}
                rows[(kname, name, H, F, act, with_res)] = row
                log(f"[gat-timing] {kname} {name} H={H} F={F} act={act} "
                    f"res={with_res}: device {row['ms']:.5f} ms, bound "
                    f"{row['bound_ms']:.5f} ms ({nbytes} B), plain "
                    f"{row['plain_ms']:.5f} ms, library (partial, "
                    f"{lib_what[kind]}) {row['library_ms']} ms; "
                    f"card: {card}")
            del x, z, gout, alpha, pos, d_pre
    return {"rows": rows, "layers": layers, "referenced_rows": referenced,
            "live_rows": live_rows, "B": B, "N": N, "D": D}


def bag_library_inputs(x, nbr, mask):
    """Inputs of aten._embedding_bag over the [B*N*H, F] view of x [B,N,H,F]:
    one bag per (row, head) of its D slots, padded slots naming an extra
    zero row passed as padding_idx. A yardstick only; the port never calls
    it."""
    B, N, H, F = x.shape
    D = nbr.shape[2]
    offs = (torch.arange(B, device=x.device) * N).view(B, 1, 1)
    rows = torch.where(mask > 0, nbr + offs, B * N)                 # [B,N,D]
    heads = torch.arange(H, device=x.device).view(1, 1, 1, H)
    idx = torch.where(rows[..., None] < B * N, rows[..., None] * H + heads,
                      B * N * H)                                     # [B,N,D,H]
    flat = idx.permute(0, 1, 3, 2).reshape(-1).contiguous()
    weight = torch.cat([x.reshape(B * N * H, F), x.new_zeros(1, F)])
    offsets = torch.arange(0, flat.numel(), D, device=x.device)
    return flat, offsets, weight, B * N * H


def phase_decomposed_timing(dataset, card) -> dict:
    """The decomposed kernels at the training batch's own table (B=6,
    N=8192, D=12), f32 and bf16: wsum, wsum_bwd and pairdot at
    DECOMPOSED_SHAPES, slot_gather at the GAT's head counts and SLOT_WIDTHS,
    slot_gather_bwd at the head counts; device ms per launch (CUDA-graph
    replay), plain ms and the byte bound, and the library yardstick: the
    weighted embedding_bag (aten._embedding_bag, mode sum, per-sample
    weights) for wsum, its weight backward (aten._embedding_bag_dense_backward,
    over the same weights read through the bags) for wsum_bwd, its
    per-sample-weight backward (aten._embedding_bag_per_sample_weights_backward)
    for pairdot, F.embedding for slot_gather (in both types) and its backward
    (aten.embedding_dense_backward) for slot_gather_bwd; the others in f32
    only. Each is one call that computes the same function. These launches
    come after the main path's counts were read and are not part of them."""
    import torch.nn.functional as F_

    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.kernels.slot_gather import (
        slot_gather, slot_gather_backward, slot_gather_backward_plain,
        slot_gather_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum import (
        pairdot, pairdot_plain, weighted_sum, weighted_sum_plain,
        weighted_sum_reverse, weighted_sum_reverse_plain)

    dev = torch.device("cuda")
    batch = batch_graphs([dataset.get_graph(i) for i in range(len(dataset))]).to(dev)
    nbr, mask, rslot = batch.nbr, batch.nbr_mask, batch.rslot
    B, N, D = nbr.shape
    offs = (torch.arange(B, device=dev) * N).view(B, 1, 1)
    referenced = int(torch.unique((nbr + offs)[mask > 0]).numel())
    live_rows = int((mask > 0).any(dim=2).sum())
    real = int((mask > 0).sum())
    table = B * N * D * 4
    aten = torch.ops.aten
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, lib_err = {}, {}

    def timed(key, kern, plain, lib, nbytes, tag):
        row = {"ms": time_device(kern),
               "plain_ms": time_device(plain, reps=5, inner=3),
               "library_ms": None if lib is None else time_device(lib),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
        rows[key] = row
        log(f"[dec-timing] {tag}: device {row['ms']:.5f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({nbytes} B), plain {row['plain_ms']:.5f} "
            f"ms, library {row['library_ms']} ms; card: {card}")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        f32 = dtype == torch.float32
        for H, F in DECOMPOSED_SHAPES:
            HF = H * F
            values = torch.randn((B, N, H, F), generator=gen, device=dev).to(dtype)
            gout = torch.randn((B, N, H, F), generator=gen, device=dev).to(dtype)
            w = torch.rand((B, N, D, H), generator=gen, device=dev)
            libs = {"wsum": None, "wsum_bwd": None, "pairdot": None}
            if f32:
                flat, offsets, weight, pad = bag_library_inputs(values, nbr, mask)
                psw = w.permute(0, 1, 3, 2).reshape(-1).contiguous()
                _, o2b, bsz, mxi = aten._embedding_bag.default(
                    weight, flat, offsets, False, 0, False, psw, False, pad)
                g_flat = gout.reshape(B * N * H, F)
                libs = {
                    "wsum": lambda: aten._embedding_bag.default(
                        weight, flat, offsets, False, 0, False, psw, False, pad),
                    "wsum_bwd": lambda: aten._embedding_bag_dense_backward.default(
                        g_flat, flat, o2b, bsz, mxi, pad + 1, False, 0, psw, pad),
                    "pairdot": lambda: aten._embedding_bag_per_sample_weights_backward
                    .default(g_flat, weight, flat, offsets, o2b, 0, pad)}
                lib_err[("wsum", H, F)] = within(
                    libs["wsum"]()[0].reshape(B, N, H, F),
                    weighted_sum(values, w, nbr, mask))
                lib_err[("wsum_bwd", H, F)] = within(
                    libs["wsum_bwd"]()[:pad].reshape(B, N, H, F),
                    weighted_sum_reverse(gout, w, nbr, mask, rslot))
                lib_err[("pairdot", H, F)] = within(
                    libs["pairdot"]().reshape(B, N, H, D).permute(0, 1, 3, 2),
                    pairdot(gout, values, nbr, mask))
            tag = f"B={B} N={N} D={D} H={H} F={F} {name}"
            # compulsory bytes: each input read once (the referenced rows of
            # a gathered tensor, the weights of real slots), each output
            # written once
            timed(("wsum", name, H, F),
                  lambda: weighted_sum(values, w, nbr, mask),
                  lambda: weighted_sum_plain(values, w, nbr, mask), libs["wsum"],
                  referenced * HF * es + real * H * 4 + 2 * table
                  + B * N * HF * es, f"wsum {tag}")
            timed(("wsum_bwd", name, H, F),
                  lambda: weighted_sum_reverse(gout, w, nbr, mask, rslot),
                  lambda: weighted_sum_reverse_plain(gout, w, nbr, mask, rslot),
                  libs["wsum_bwd"],
                  referenced * HF * es + real * H * 4 + 3 * table
                  + B * N * HF * es, f"wsum_bwd {tag}")
            timed(("pairdot", name, H, F),
                  lambda: pairdot(gout, values, nbr, mask),
                  lambda: pairdot_plain(gout, values, nbr, mask), libs["pairdot"],
                  live_rows * HF * es + referenced * HF * es + 2 * table
                  + B * N * D * H * 4, f"pairdot {tag}")
            del values, gout, w, libs
        heads = {h for h, _, _, _ in gat_layers()}
        for W in sorted(heads | set(SLOT_WIDTHS)):
            x = torch.randn((B, N, W), generator=gen, device=dev).to(dtype)
            g = torch.randn((B, N, D, W), generator=gen, device=dev).to(dtype)
            ridx = torch.where(mask > 0, nbr + offs, B * N).reshape(-1)
            wt = torch.cat([x.reshape(B * N, W), x.new_zeros(1, W)])
            lib_f = lambda: F_.embedding(ridx, wt, padding_idx=B * N)
            lib_b = None
            if f32:
                g_rows = g.reshape(B * N * D, W)
                lib_b = lambda: aten.embedding_dense_backward.default(
                    g_rows, ridx, B * N + 1, B * N, False)
                lib_err[("slot_gather_bwd", W)] = within(
                    lib_b()[:B * N].reshape(B, N, W),
                    slot_gather_backward(g, nbr, mask, rslot))
            lib_err[("slot_gather", name, W)] = within(
                lib_f().reshape(B, N, D, W), slot_gather(x, nbr, mask))
            tag = f"B={B} N={N} D={D} W={W} {name}"
            timed(("slot_gather", name, W),
                  lambda: slot_gather(x, nbr, mask),
                  lambda: slot_gather_plain(x, nbr, mask), lib_f,
                  referenced * W * es + 2 * table + B * N * D * W * es,
                  f"slot_gather {tag}")
            if W in heads:
                timed(("slot_gather_bwd", name, W),
                      lambda: slot_gather_backward(g, nbr, mask, rslot),
                      lambda: slot_gather_backward_plain(g, nbr, mask, rslot), lib_b,
                      real * W * es + 3 * table + B * N * W * es,
                      f"slot_gather_bwd {tag}")
            del x, g
    log(f"[dec-timing] library yardsticks against the kernels, largest "
        f"difference relative to the largest value: "
        f"{ {str(k): round(v, 9) for k, v in lib_err.items()} }")
    return {"rows": rows, "referenced_rows": referenced, "live_rows": live_rows,
            "real_slots": real, "B": B, "N": N, "D": D, "library_err": lib_err}


def dec_per_step(dtime, parts, dtype="float32") -> dict:
    """Sum the decomposed timing rows of `parts` ((key without the dtype,
    launches) pairs) into one step's totals."""
    out = {}
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [(n, dtime["rows"][(key[0], dtype, *key[1:])][k]) for key, n in parts]
        out[k] = (None if any(v is None for _, v in vals)
                  else sum(n * v for n, v in vals))
    return out


def gat_per_step(gtime, kname, dtype="float32") -> dict:
    """One GAT training step's (or serve request's, for gat_fwd_serve) sum
    over the hardcoded GAT's layers of a kernel's timing rows."""
    rows = gtime["rows"]
    out = {}
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [rows[(kname, dtype, h, f, *((a, r) if kname.startswith("gat_fwd")
                                              else (None, False)))][k]
                for h, f, a, r in gtime["layers"]]
        out[k] = None if any(v is None for v in vals) else sum(vals)
    return out


# ---------------------------------------------------------------------------


def per_step(rows, parts, dtype="float32") -> dict:
    """Sum the timing rows of `parts` ((kernel, F, launches) triples) into
    one step's totals."""
    out = {}
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [(n, rows[(kern, dtype, F)][k]) for kern, F, n in parts]
        out[k] = (None if any(v is None for _, v in vals)
                  else sum(n * v for n, v in vals))
    return out


def tp_rows(rows, kname) -> dict:
    """A max kernel's f32 timing rows at phase 10's widths (TP_WIDTHS)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    return {f"F={F}": {k: rows[(kname, "float32", F)][k] for k in keys}
            for F in TP_WIDTHS}


def gat_tp_rows(gtime, kname) -> dict:
    """A GAT kernel's f32 timing row at phase 10's head-parallel shape."""
    H, F, act, res = TP_GAT_LAYERS[0]
    key = (kname, "float32", H, F, *((act, res) if kname == "gat_fwd"
                                     else (None, False)))
    return {f"(H,F)=({H},{F})": {k: gtime["rows"][key][k] for k in
                                 ("ms", "plain_ms", "library_ms", "bound_ms")}}


# ---------------------------------------------------------------------------
# phase 8: the four-step pipeline
# ---------------------------------------------------------------------------

PIPE_GNN_EPOCHS = 2
PIPE_CNN_EPOCHS = 3
CNN_CHECK_CROP = 48
# one exact CNN step on the card against the same step on the CPU: float32
# convolutions of 125 x C taps, summed over the crop in another order
CNN_LOSS_RTOL = 1e-5
CNN_GRAD_TOL = 1e-4      # of each gradient's largest entry
CNN_PARAM_ATOL = 1e-6    # after AdamW's first step (each entry moves ~lr)
CNN_STEP_REPS = 10


def _cli_step(name, fn, argv, walls) -> dict:
    """One CLI step as a user runs it (its main(argv)), with every kernel
    count set to 0 just before it and read just after; records its wall
    time."""
    read = _reset_counts()
    t = time.perf_counter()
    fn(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t
    return read()


def _check_labels(d, ids, shape, what):
    from gnn_tumor_seg_tpu_torch.data import nifti

    for mri_id in ids:
        pred = nifti.read_nifti(os.path.join(d, f"{mri_id}.nii.gz"), np.int16)
        check(pred.shape == tuple(shape), f"{what} {mri_id}: shape {pred.shape}")
        vals = set(np.unique(pred).tolist())
        check(vals <= {0, 1, 2, 4}, f"{what} {mri_id}: labels {sorted(vals)}")


def _jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cnn_macs_per_voxel(hp) -> int:
    """Multiply-adds per voxel of one CNN training step, from the layer
    widths: the forward of both convolutions, then conv1's input and weight
    gradients and conv0's weight gradient (conv0's input needs none)."""
    c0, c1, c2 = hp.in_feats, hp.layer_sizes[0], hp.out_classes
    taps = 5 ** 3
    return taps * (c0 * c1 + c1 * c2) + taps * (2 * c1 * c2 + c0 * c1)


def cnn_step_matches_cpu(card, device="cuda") -> dict:
    """One exact CNN training step at a CNN_CHECK_CROP^3 crop (floor off)
    on the card against the same step on the CPU, from the same parameters
    and inputs: loss within CNN_LOSS_RTOL, gradients within CNN_GRAD_TOL of
    each tensor's largest entry, parameters after AdamW within
    CNN_PARAM_ATOL."""
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters
    from gnn_tumor_seg_tpu_torch.train.cnn_trainer import CNNTrainer, PreparedSample

    hp = hardcoded_hyperparameters("CNN")
    rng = np.random.default_rng(SEED)
    n = CNN_CHECK_CROP
    x = rng.normal(size=(1, n, n, n, hp.in_feats)).astype(np.float32)
    lab = rng.integers(0, 4, (1, n, n, n)).astype(np.int32)
    lab[:, n - 6:] = -1                               # padding rows
    mask = (lab >= 0).astype(np.float32)
    crop = np.ix_(np.arange(n - 6), np.arange(n), np.arange(n))
    out = {}
    for dev in (device, "cpu"):
        t = CNNTrainer(hp, seed=SEED, crop_floor=None, precision="exact",
                       device=dev)
        prep = PreparedSample(*(torch.from_numpy(a).to(dev) for a in (x, lab, mask)),
                              crop=crop)
        with t.compute_scope():
            loss = t._step(prep)
        out[dev] = (float(loss), [p.grad.detach().cpu() for p in t.net.jax_parameters()],
                    [p.detach().cpu() for p in t.net.jax_parameters()])
    (lc, gc, pc), (lh, gh, ph) = out[device], out["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    grad_rel = max(within(a, b) for a, b in zip(gc, gh))
    param_abs = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    check(loss_rel <= CNN_LOSS_RTOL and grad_rel <= CNN_GRAD_TOL
          and param_abs <= CNN_PARAM_ATOL,
          f"exact CNN step on {device} against the CPU: loss {loss_rel:.3g} "
          f"relative, gradients {grad_rel:.3g} of their largest entry, "
          f"parameters {param_abs:.3g}")
    log(f"[pipeline] exact CNN step at {n}^3 on {device} against the CPU: loss "
        f"{lc:.7f} vs {lh:.7f} ({loss_rel:.3g} relative, tolerance "
        f"{CNN_LOSS_RTOL}), gradients within {grad_rel:.3g} of their largest "
        f"entry ({CNN_GRAD_TOL}), parameters within {param_abs:.3g} "
        f"({CNN_PARAM_ATOL}); card: {card}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "param_abs": param_abs}


def time_cnn_step(trainer, prep, reps: int = CNN_STEP_REPS) -> dict:
    """Median ms of one CNN training step (forward, loss, backward, AdamW)
    on a prepared sample, under the trainer's precision and cuDNN settings:
    CUDA events around each step, after 2 warm-up steps; and the first
    step's wall seconds (cuDNN times its algorithms for a new shape)."""
    times = []
    with trainer.compute_scope():
        for i in range(reps + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            trainer._step(prep)
            end.record()
            end.synchronize()
            if i == 0:
                first_s = time.perf_counter() - t
            if i >= 2:
                times.append(start.elapsed_time(end))
    return {"ms": statistics.median(times), "first_s": first_s,
            "ms_all": [round(v, 4) for v in times]}


def profile_cnn_epoch(trainer) -> dict:
    """One epoch under torch.profiler: its wall time, the device's busy time
    and idle share, and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run_epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    on_device = device_events(prof)
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3
    check(busy_ms > 0, "the profiler saw no device time in a CNN epoch")
    top = [[e.key[:60], round(_device_us(e) / 1e3, 4), e.count]
           for e in on_device[:8]]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "top": top}


def phase_pipeline(tmp: str, card: str, device="cuda", num_nodes=NUM_NODES) -> dict:
    """The four steps of scripts/run_pipeline_cuda.sh as a user runs them,
    through each CLI's main, on phase 6's two full-size brains preprocessed
    with cli.preprocess: cli.train_gnn -m GSpool -k 1 at TRAIN_WIDTHS
    (PIPE_GNN_EPOCHS epochs), cli.generate_gnn_predictions -f logits and
    once -f preds, cli.train_refinement_cnn -k 1 with the hardcoded CNN
    (PIPE_CNN_EPOCHS epochs, the later ones from the prep cache), and
    cli.generate_joint_predictions --precision exact, then fast. Every step
    writes its files, label volumes are BRAIN_SHAPE in BraTS labels, logits
    are finite, the prep cache is hit by every brain from epoch 2 on and by
    the evaluation, and the GNN steps launch max_agg (and training
    max_agg_bwd) as the model needs. On the card, the CNN's exact step is
    held to the CPU's, two exact epochs from one seed must be bitwise
    equal, and the CNN step (at the 128^3 floor and at a brain's crop) and
    a cached epoch are timed and profiled."""
    from gnn_tumor_seg_tpu_torch.cli import (generate_gnn_predictions,
                                             generate_joint_predictions,
                                             preprocess, train_gnn,
                                             train_refinement_cnn)
    from gnn_tumor_seg_tpu_torch.config import hardcoded_hyperparameters
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.data.dataset import (ImageGraphDataset,
                                                      PredLogitDataset)
    from gnn_tumor_seg_tpu_torch.train.cnn_trainer import (DEFAULT_CROP_FLOOR,
                                                           CNNTrainer, PreparedSample)

    raw = os.path.join(tmp, "raw")
    root = os.path.join(tmp, "pipeline")
    store, logs = os.path.join(root, "store"), os.path.join(root, "logs")
    logit_dir = os.path.join(root, "logits")
    walls: dict = {}
    shape = nifti.read_nifti(os.path.join(raw, "BraTS_000", "BraTS_000_seg.nii.gz")).shape
    t = time.perf_counter()
    preprocess.main(["-d", raw, "-o", store, "-n", str(num_nodes), "-k", "10",
                     "-l", "_seg.nii.gz"])
    walls["preprocess"] = time.perf_counter() - t
    ids = sorted(os.listdir(store))
    n = len(ids)
    dev = ["--device", device]
    layers = len(TRAIN_WIDTHS) + 1
    on_card = device == "cuda"
    launches = {}

    def want(**kw):
        return {**NO_LAUNCHES, **(kw if on_card else {})}

    # step 1: train the GNN
    launches["train_gnn"] = _cli_step("train_gnn", train_gnn.main, [
        "-d", store, "-o", logs, "-r", "pipe_gnn", "-m", "GSpool", "-k", "1",
        "--hp", f"layer_sizes={TRAIN_WIDTHS}", "--hp", f"n_epochs={PIPE_GNN_EPOCHS}",
        *dev], walls)
    gnn_ckpt = os.path.join(logs, "pipe_gnn_f1.ckpt")
    check(os.path.exists(gnn_ckpt), "step 1 wrote no GNN checkpoint")
    steps = sum(e["steps"] for e in _jsonl(os.path.join(logs, "pipe_gnn.txt.jsonl"))
                if e.get("event") == "epoch")
    check(launches["train_gnn"] == want(max_agg=layers * (steps + 1),
                                        max_agg_bwd=layers * steps),
          f"step 1 launches {launches['train_gnn']} for {steps} steps")
    # step 2: GNN logits, and once the GNN's own labels
    launches["gnn_logits"] = _cli_step(
        "gnn_logits", generate_gnn_predictions.main,
        ["-d", store, "-o", logit_dir, "-w", gnn_ckpt, "-f", "logits", *dev], walls)
    launches["gnn_preds"] = _cli_step(
        "gnn_preds", generate_gnn_predictions.main,
        ["-d", store, "-o", os.path.join(root, "gnn_preds"), "-w", gnn_ckpt,
         "-f", "preds", *dev], walls)
    for k in ("gnn_logits", "gnn_preds"):
        check(launches[k] == want(max_agg=layers * n), f"{k} launches {launches[k]}")
    logits = PredLogitDataset(logit_dir)
    for mri_id in ids:
        v = logits.read_logits(mri_id)
        check(v.ndim == 4 and v.shape[-1] == 4 and bool(np.isfinite(v).all()),
              f"{mri_id}: logits {v.shape}, finite {bool(np.isfinite(v).all())}")
    _check_labels(os.path.join(root, "gnn_preds"), ids, shape, "GNN labels")
    # step 3: train the refinement CNN
    launches["train_cnn"] = _cli_step("train_cnn", train_refinement_cnn.main, [
        "-d", store, "-l", logit_dir, "-o", logs, "-r", "pipe_cnn", "-k", "1",
        "--hp", f"n_epochs={PIPE_CNN_EPOCHS}", *dev], walls)
    check(launches["train_cnn"] == NO_LAUNCHES, f"step 3 launches {launches['train_cnn']}")
    cnn_ckpt = os.path.join(logs, "pipe_cnn_f1.ckpt")
    check(os.path.exists(cnn_ckpt), "step 3 wrote no CNN checkpoint")
    records = _jsonl(os.path.join(logs, "pipe_cnn.txt.jsonl"))
    epochs = [r for r in records if r.get("event") == "epoch"]
    evals = [r for r in records if r.get("event") == "evaluate"]
    hits = [e["prep_cache_hits"] for e in epochs]
    check(len(epochs) >= 2 and hits == [0] + [n] * (len(epochs) - 1)
          and len(evals) == 1 and evals[0]["prep_cache_hits"] == n,
          f"prep cache hits: epochs {hits}, evaluation "
          f"{[r['prep_cache_hits'] for r in evals]}, for {n} brains")
    check(all(np.isfinite(e["loss"]) for e in epochs), "non-finite CNN losses")
    # step 4: joint predictions, exact then fast
    joint = {}
    for mode in ("exact", "fast"):
        out = os.path.join(root, f"joint_{mode}")
        key = f"joint_{mode}"
        launches[key] = _cli_step(key, generate_joint_predictions.main, [
            "-d", store, "-o", out, "-g", gnn_ckpt, "-c", cnn_ckpt,
            "--precision", mode, *dev], walls)
        check(launches[key] == want(max_agg=layers * n), f"{key} launches {launches[key]}")
        _check_labels(out, ids, shape, f"joint labels ({mode})")
        joint[mode] = walls[key] / n
    totals = {k: sum(c[k] for c in launches.values()) for k in NO_LAUNCHES}
    if on_card:
        check(totals["max_agg"] > 0 and totals["max_agg_bwd"] > 0,
              f"pipeline launches {totals}")
    result = {"brains": n, "walls_s": walls, "joint_s_per_brain": joint,
              "cnn_epochs_s": [e["seconds"] for e in epochs],
              "cnn_losses": [e["loss"] for e in epochs],
              "prep_cache_hits": {"epochs": hits,
                                  "evaluate": evals[0]["prep_cache_hits"]},
              "launches": totals}
    log(f"[pipeline] {n} brains {shape}: step walls (s) "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}, launches "
        f"{json.dumps({k: {kk: vv for kk, vv in c.items() if vv} for k, c in launches.items()})}; "
        f"card: {card}")
    if not on_card:
        return result
    # the CNN on the card: its exact step against the CPU's, determinism,
    # step and epoch time
    hp = hardcoded_hyperparameters("CNN")
    result["cpu_check"] = cnn_step_matches_cpu(card, device)
    images = ImageGraphDataset(store, read_graph=False)
    ta = CNNTrainer(hp, images, logits, seed=SEED, precision="exact", device=device)
    ta.run_epoch()                                       # fills the prep cache
    tb = CNNTrainer(hp, images, logits, seed=SEED, precision="exact", device=device)
    tb._prep_cache = ta._prep_cache
    tb.run_epoch()
    diff = max(float((a - b).detach().abs().max()) for a, b in
               zip(ta.net.jax_parameters(), tb.net.jax_parameters()))
    check(diff == 0, f"two exact CNN epochs from one seed differ by {diff:.3g}")
    result["exact_epochs_max_abs_diff"] = diff
    # the CNN step at the floor (a 128^3 corner of the first brain's crop,
    # a shape cuDNN has not seen) and at that brain's whole crop
    full = ta._prep_cache.get((logits.root, ids[0]))
    f = DEFAULT_CROP_FLOOR
    corner = PreparedSample(full.x[:, :f[0], :f[1], :f[2]].contiguous(),
                            full.labels[:, :f[0], :f[1], :f[2]].contiguous(),
                            full.mask[:, :f[0], :f[1], :f[2]].contiguous(), full.crop)
    tf = CNNTrainer(hp, images, logits, seed=SEED, precision="fast", device=device)
    tf._prep_cache = ta._prep_cache
    steps_ms, tflops, flop = {}, {}, {}
    for name, prep in (("floor", corner), ("crop", full)):
        flop[name] = 2 * cnn_macs_per_voxel(hp) * int(np.prod(prep.x.shape[1:4]))
        for t in (ta, tf):
            key = f"{t.precision}_{name}"
            steps_ms[key] = time_cnn_step(t, prep)
            tflops[key] = flop[name] / (steps_ms[key]["ms"] * 1e-3) / 1e12
    profiles = {"fast": profile_cnn_epoch(tf), "exact": profile_cnn_epoch(ta)}
    result.update(crop=list(full.x.shape[1:4]), step_flop=flop, step_ms=steps_ms,
                  tflops=tflops, epoch_profile=profiles)
    log("[pipeline] " + json.dumps({
        "brains": n, "step_wall_s": {k: round(v, 3) for k, v in walls.items()},
        "joint_s_per_brain": joint,
        "cnn_crop": result["crop"], "cnn_step_flop": flop,
        "cnn_step_ms": {k: v["ms"] for k, v in steps_ms.items()},
        "cnn_first_step_s": {k: v["first_s"] for k, v in steps_ms.items()},
        "cnn_step_tflops": tflops,
        "cli_cnn_epoch_s": result["cnn_epochs_s"],
        "prep_cache_hits": result["prep_cache_hits"],
        "cnn_epoch_idle_share": {k: v["idle_share"] for k, v in profiles.items()},
        "cnn_epoch_busy_ms": {k: v["busy_ms"] for k, v in profiles.items()},
        "cnn_epoch_wall_ms": {k: v["wall_ms"] for k, v in profiles.items()},
        "exact_epochs_max_abs_diff": diff,
        "cpu_check": result["cpu_check"],
        "launches": totals, "card": card}))
    for mode, p in profiles.items():
        log(f"[pipeline] cached {mode} CNN epoch top kernels: {json.dumps(p['top'])}")
    return result


# ---------------------------------------------------------------------------
# phase 9: distributed training, two ranks on the one card
# ---------------------------------------------------------------------------

DIST_LOGIT_TOL = 1e-5     # of the largest logit, "exact"
DIST_GRAD_TOL = 1e-4      # of each gradient's largest entry, "exact"
DIST_TIMED_STEPS = 5
DIST_DEADLINE_S = 300
DIST_EPOCHS = 2           # a --parallel run, in "fast"


def dist_step_launches(model_type) -> dict:
    """A rank's kernel launches a training step: one forward and one
    backward kernel per GSpool layer, the three attention kernels per GAT
    layer."""
    layers = len(_train_hp(model_type).layer_sizes) + 1
    if model_type == "GSpool":
        return {"max_agg": layers, "max_agg_bwd": layers}
    return {"gat_fwd": layers, "gat_bwd": layers, "gat_rev": layers}


def dist_cli_argv(data_dir, out_dir, run, model_type, parallel, mesh, n_epochs,
                  device, variant) -> list[str]:
    """cli.train_gnn's arguments for one --parallel run (-k 1)."""
    hp = _train_hp(model_type)
    argv = ["-d", data_dir, "-o", out_dir, "-r", run, "-m", model_type, "-k", "1",
            "--hp", f"layer_sizes={hp.layer_sizes}", "--hp", f"n_epochs={n_epochs}",
            "--device", device, "--parallel", parallel, "--mesh", str(mesh)]
    return argv + (["--halo_variant", variant] if variant else [])


def start_dist_run(argv, mesh, per_rank, log_path) -> list:
    """Start `python -m gnn_tumor_seg_tpu_torch.cli.train_gnn argv` in
    "fast": one command that spawns its `mesh` ranks, or with `per_rank` one
    command a rank joined through --coordinator/--num_processes/--process_id.
    Each command leads a session of its own, so a kill reaches its ranks."""
    cmd = [sys.executable, "-m", "gnn_tumor_seg_tpu_torch.cli.train_gnn", *argv]
    if per_rank:
        from gnn_tumor_seg_tpu_torch.parallel.mesh import free_port

        coordinator = f"localhost:{free_port()}"
        cmds = [cmd + ["--coordinator", coordinator, "--num_processes", str(mesh),
                       "--process_id", str(r)] for r in range(mesh)]
    else:
        cmds = [cmd]
    env = {**os.environ, "GTS_PALLAS_PRECISION": "fast"}
    procs = []
    for i, c in enumerate(cmds):
        with open(f"{log_path}.{i}", "w") as out:
            procs.append(subprocess.Popen(c, cwd=ROOT, env=env, stdout=out,
                                          stderr=subprocess.STDOUT,
                                          start_new_session=True))
    return procs


def wait_dist_runs(started: dict, deadline_s: float) -> None:
    """Wait for every command of `started` ({run: (procs, log_path)}); kill
    them all and fail when one exits non-zero or the deadline passes."""
    import signal

    end = time.perf_counter() + deadline_s
    try:
        for run, (procs, log_path) in started.items():
            for i, proc in enumerate(procs):
                rc = proc.wait(timeout=max(1.0, end - time.perf_counter()))
                if rc != 0:
                    with open(f"{log_path}.{i}") as f:
                        tail = f.read()[-3000:]
                    check(False, f"{run}: command {i} exited {rc}:\n{tail}")
    except subprocess.TimeoutExpired:
        check(False, f"--parallel runs still running after {deadline_s} s")
    finally:
        for procs, _ in started.values():
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()


def check_dist_run(data_dir, out_dir, run, model_type, mesh, n_epochs, card,
                   device="cuda", label="") -> dict:
    """Checks of one finished --parallel run in "fast": one JSON-lines record
    an epoch and one progress row, from rank 0 alone; the per-rank launches
    of each step (read from the epoch records, which carry every rank's
    counts); finite losses that fall; and rank 0's checkpoint served through
    load_gnn_from_checkpoint on this process."""
    from gnn_tumor_seg_tpu_torch.cli.common import load_gnn_from_checkpoint
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset

    epochs = _jsonl(os.path.join(out_dir, f"{run}.txt.jsonl"))
    epochs = [e for e in epochs if e.get("event") == "epoch" and e["run"] == run]
    check(len(epochs) == n_epochs,
          f"{run}: {len(epochs)} epoch records for {n_epochs} epochs")
    with open(os.path.join(out_dir, f"{run}.txt")) as f:
        text = f.read()
    rows = [line for line in text.splitlines() if line.startswith(f"{run}_full\t")]
    check(len(rows) == 1 and text.count("Fold\tLoss") == 1,
          f"{run}: progress file has {len(rows)} result rows")
    per_step = {k: (v if device == "cuda" else 0)
                for k, v in dist_step_launches(model_type).items()}
    launches = dict(NO_LAUNCHES)
    for e in epochs:
        check(len(e["launches_by_rank"]) == mesh,
              f"{run}: launch counts of {len(e['launches_by_rank'])} ranks")
        want = {**NO_LAUNCHES, **{k: v * e["steps"] for k, v in per_step.items()}}
        for r, counts in enumerate(e["launches_by_rank"]):
            check(counts == want, f"{run} rank {r}: launches {counts}, "
                                  f"expected {want}")
            for k, v in counts.items():
                launches[k] += v
    losses = [e["loss"] for e in epochs]
    check(all(np.isfinite(losses)), f"{run}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"{run}: fast loss did not fall {losses}")
    model, _, forward = load_gnn_from_checkpoint(
        os.path.join(out_dir, f"{run}_f1.ckpt"), device=device)
    graph = ImageGraphDataset(data_dir, read_image=False).get_graph(0)
    read = _reset_counts()
    logits = forward(graph)
    if device == "cuda":
        torch.cuda.synchronize()
        kernel = "max_agg" if model_type == "GSpool" else "gat_fwd"
        check(read() == {**NO_LAUNCHES, kernel: model.num_layers},
              f"{run}: served checkpoint launched {read()}")
    check(bool(torch.isfinite(logits).all()), f"{run}: served logits not finite")
    step_ms = [e["seconds"] / e["steps"] * 1e3 for e in epochs]
    log(f"[dist] {run}: {label}, fast, losses {losses}, per rank and step "
        f"{per_step}, epoch step ms {[round(x, 3) for x in step_ms]}; "
        f"checkpoint served; card: {card}")
    return {"losses": losses, "launches": launches, "step_ms": step_ms}


def _dist_parity_rank(rank, world, init, data_dir, out_dir, device, timed):
    """A rank of the parity world. In "exact", through the trainers' own
    loss_and_grads: the DP loss and summed gradients of one global batch
    (all samples, rank r's slice) with its logits, and for every halo model
    (GSpool and GAT, p2p and all_gather) the own-row logits, the loss and
    the summed gradients on the union of all samples. With `timed`, the
    fast DP and halo steps."""
    sys.path.insert(0, ROOT)
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.parallel.dp import ParallelGNNTrainer
    from gnn_tumor_seg_tpu_torch.parallel.halo_data import build_partitioned_sets
    from gnn_tumor_seg_tpu_torch.parallel.halo_trainer import HaloTrainer
    from gnn_tumor_seg_tpu_torch.parallel.mesh import (initialize_multihost,
                                                       shutdown)

    mesh = initialize_multihost(init, world, rank, device=device, timeout_s=120)
    dev = mesh.device
    out = {"backend": np.asarray(mesh.backend),
           "staged": np.asarray(mesh.staged)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed_steps(step):
        for _ in range(2):
            step()
        sync()
        ms = []
        for _ in range(DIST_TIMED_STEPS):
            t = time.perf_counter()
            step()
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        return np.asarray(ms)

    def grads(prefix, params):
        for i, p in enumerate(params):
            out[f"{prefix}/{i}"] = p.grad.cpu().numpy()

    try:
        dataset = ImageGraphDataset(data_dir, read_image=False)
        n = len(dataset)
        local = n // world
        hp = _train_hp("GSpool")
        hp.batch_size = n
        tr = ParallelGNNTrainer("GSpool", hp, dataset, seed=SEED, mesh=mesh,
                                precision="exact")
        n_pad, d_pad = tr._shape_budget
        batch = batch_graphs([dataset.get_graph(i) for i in
                              range(rank * local, (rank + 1) * local)],
                             n_pad=n_pad, d_pad=d_pad).to(dev)
        with precision_scope("exact"):
            out["dp_loss"] = np.float64(tr.loss_and_grads(batch).item())
            with torch.no_grad():
                out["dp_logits"] = tr.model(batch, train=True).cpu().numpy()
        grads("dp_grad", tr.model.jax_parameters())
        if timed:
            gen = torch.Generator(device=dev).manual_seed(SEED)

            def dp_step():
                with precision_scope("fast"):
                    tr._step(batch, gen)
            out["dp_step_ms"] = timed_steps(dp_step)
        for variant in ("p2p", "all_gather"):
            (batches,), used, w = build_partitioned_sets(
                dataset, world, n, variant, [list(range(n))])
            if used != variant:
                raise RuntimeError(f"{variant} partition came out {used}")
            for model_type in ("GSpool", "GAT"):
                key = f"{model_type}/{variant}"
                ht = HaloTrainer(model_type, _train_hp(model_type),
                                 [batches[0].pg], mesh, variant=variant,
                                 halo_width=w, seed=SEED, precision="exact")
                rg = ht.graphs[0]
                out[f"halo/{key}"] = ht.own_logits(rg).cpu().numpy()
                with precision_scope("exact"):
                    out[f"halo_loss/{key}"] = np.float64(
                        ht.loss_and_grads(rg).item())
                grads(f"halo_grad/{key}", ht.model.jax_parameters())
                if timed:
                    gen = torch.Generator(device=dev).manual_seed(SEED)

                    def halo_step():
                        with precision_scope("fast"):
                            ht._step(rg, gen)
                    out[f"halo_step_ms/{key}"] = timed_steps(halo_step)
        np.savez(os.path.join(out_dir, f"parity_r{rank}.npz"), **out)
    finally:
        shutdown()


def _time_single_step(model_type, batch, device, steps=DIST_TIMED_STEPS):
    """A single-device fast training step (forward, loss, backward, AdamW)
    on `batch`, median ms after 2 warm-up steps."""
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy
    from gnn_tumor_seg_tpu_torch.train.optim import make_optimizer

    hp = _train_hp(model_type)
    model = init_graph_net(model_type, hp,
                           torch.Generator().manual_seed(SEED)).to(device)
    opt = make_optimizer(model.jax_parameters(), hp)
    cw = torch.tensor(hp.class_weights, device=device)
    ms = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with precision_scope("fast"):
            loss = weighted_cross_entropy(model(batch, train=True), batch.labels,
                                          cw, batch.node_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        if i >= 2:
            ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def check_kernels_on_halo_tables(dev, tables) -> dict:
    """The halo path's kernels against their plain versions on the rank
    tables phase 9 trains on (`tables`: (tag, B=1 GraphBatch with rslot),
    (2W + shard) or the union's rows at its D): max_agg (arg stored) and
    max_agg_bwd bitwise at F = 20 and 256, the three GAT kernels at the
    hardcoded GAT's (H, F) with ELU and a residual (forward within
    GAT_FWD_TOL, backward within GAT_BWD_TOL, reverse combine bitwise), f32
    and bf16. Returns the largest relative difference per kernel."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import (
        fused_gat_backward, fused_gat_backward_plain, fused_gat_forward,
        fused_gat_forward_plain, gat_reverse_combine, gat_reverse_combine_plain)
    from gnn_tumor_seg_tpu_torch.ops.kernels.max_agg import (
        max_aggregate, max_aggregate_backward, max_aggregate_backward_plain,
        max_aggregate_plain)

    rng = np.random.default_rng(SEED + 9)
    worst = {k: 0.0 for k in ("max_agg", "max_agg_bwd", "gat_fwd", "gat_bwd",
                              "gat_rev")}
    for tag, g in tables:
        nbr, mask, rslot = g.nbr, g.nbr_mask, g.rslot
        N = nbr.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            for F in (IN_FEATS, TRAIN_WIDTHS[0]):
                h = torch.from_numpy(rng.integers(-8, 8, (1, N, F)) / 4.0).to(dev, dtype)
                gout = torch.from_numpy(rng.normal(size=(1, N, F))).to(dev, dtype)
                out, arg = max_aggregate(h, nbr, mask, with_arg=True)
                w_out, w_arg = max_aggregate_plain(h, nbr, mask)
                grad = max_aggregate_backward(gout, arg, nbr, mask, rslot)
                w_grad = max_aggregate_backward_plain(gout, arg, nbr, mask, rslot)
                check(torch.equal(_bits(out), _bits(w_out)) and torch.equal(arg, w_arg)
                      and torch.equal(_bits(grad), _bits(w_grad)),
                      f"max_agg / max_agg_bwd differ from their plain versions on "
                      f"the {tag} table (F={F}, {dtype})")
            for H, F in gat_head_shapes(gat_layers()):
                x = gat_inputs(rng, 1, N, H, F, dtype, dev)
                args = (x["z"], x["el"], x["er"], nbr, mask, 0.2, "elu",
                        x["res"], x["bias"])
                out, alpha, pos = fused_gat_forward(*args, save=True)
                w_out, w_alpha, w_pos = fused_gat_forward_plain(*args)
                d_pre, d_er = fused_gat_backward(x["gout"], x["z"], alpha, pos, nbr, mask)
                w_pre, w_er = fused_gat_backward_plain(x["gout"], x["z"], alpha, pos,
                                                       nbr, mask)
                d_z, d_el = gat_reverse_combine(x["gout"], alpha, d_pre, nbr, mask, rslot)
                w_z, w_el = gat_reverse_combine_plain(x["gout"], alpha, d_pre, nbr,
                                                      mask, rslot)
                errs = {"gat_fwd": max(within(out, w_out, bf16), within(alpha, w_alpha)),
                        "gat_bwd": max(within(d_pre, w_pre), within(d_er, w_er)),
                        "gat_rev": max(within(d_z, w_z), within(d_el, w_el))}
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
                check(errs["gat_fwd"] <= GAT_FWD_TOL and torch.equal(pos, w_pos)
                      and errs["gat_bwd"] <= GAT_BWD_TOL
                      and torch.equal(_bits(d_z), _bits(w_z))
                      and torch.equal(d_el, w_el),
                      f"GAT kernels differ from their plain versions on the {tag} "
                      f"table (H={H}, F={F}, {dtype}): {errs}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        log(f"[dist] kernels on the {tag} table (N={N}, D={nbr.shape[2]}): "
            f"max_agg, max_agg_bwd and gat_rev bitwise, gat_fwd within "
            f"{GAT_FWD_TOL}, gat_bwd within {GAT_BWD_TOL}, f32 and bf16")
    return worst


def phase_train_dist(data_dir: str, tmp: str, card: str, device="cuda") -> dict:
    """The cell train-dist-2rank: phase 6's 6 graphs of 7000 nodes through
    cli.train_gnn --parallel, 2 fast epochs a run, the six runs at once (so
    their epoch times are not step times): dp --mesh 2 (two ranks on the one
    card, gloo) and --mesh 1 (NCCL at world size 1) GSpool [256]*6, and halo
    --mesh 2 (one union of all 6 graphs) with p2p and all_gather, GSpool
    [256]*6 and the hardcoded GAT; one run starts a command a rank through
    --coordinator, the others spawn their ranks. Then, in a two-rank world
    of its own, DP and halo held to one device in "exact" through the
    trainers' own loss_and_grads, and (on the card) the steps of each regime
    timed beside one device's, with the analytic bytes each rank exchanges
    a step."""
    import torch.multiprocessing as mp

    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs, graph_from_arrays
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.parallel.halo import exchange_bytes_per_step
    from gnn_tumor_seg_tpu_torch.parallel.halo_data import (
        build_partitioned_sets, union_samples, unpermute_nodes)
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net
    from gnn_tumor_seg_tpu_torch.parallel.mesh import free_port
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
    from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "dist_logs")
    os.makedirs(out_dir)
    # (run, model, --parallel, --mesh, --halo_variant, one command a rank)
    plan = [("dp2", "GSpool", "dp", 2, None, False),
            ("dp1", "GSpool", "dp", 1, None, False),
            ("halo_p2p_gspool", "GSpool", "halo", 2, "p2p", False),
            ("halo_ag_gspool", "GSpool", "halo", 2, "all_gather", False),
            ("halo_p2p_gat", "GAT", "halo", 2, "p2p", False),
            ("halo_ag_gat", "GAT", "halo", 2, "all_gather", True)]
    started = {}
    for run, mt, par, mesh, variant, per_rank in plan:
        argv = dist_cli_argv(data_dir, out_dir, run, mt, par, mesh,
                             DIST_EPOCHS, device, variant)
        started[run] = (start_dist_run(argv, mesh, per_rank,
                                       os.path.join(out_dir, f"{run}.out")),
                        os.path.join(out_dir, f"{run}.out"))
    wait_dist_runs(started, DIST_DEADLINE_S)
    t_cli = time.perf_counter() - t0
    runs = {}
    for run, mt, par, mesh, variant, per_rank in plan:
        label = (f"{mt} --parallel {par} --mesh {mesh}"
                 + (f" {variant}" if variant else "")
                 + (" (a command a rank, --coordinator)" if per_rank else ""))
        runs[run] = check_dist_run(data_dir, out_dir, run, mt, mesh,
                                   DIST_EPOCHS, card, device, label)

    # parity (and timing on the card) in a world of two ranks
    par_dir = os.path.join(tmp, "dist_parity")
    os.makedirs(par_dir)
    timed = device == "cuda"
    ctx = mp.start_processes(
        _dist_parity_rank, nprocs=2, join=False, start_method="spawn",
        args=(2, f"tcp://localhost:{free_port()}", data_dir, par_dir, device,
              timed))
    end = time.perf_counter() + DIST_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            check(time.perf_counter() < end,
                  f"parity ranks still running after {DIST_DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = [dict(np.load(os.path.join(par_dir, f"parity_r{r}.npz")))
             for r in range(2)]
    dataset = ImageGraphDataset(data_dir, read_image=False)
    n = len(dataset)
    single = GNNTrainer("GSpool", _train_hp("GSpool"), dataset, seed=SEED,
                        precision="exact", device=device)
    batch = batch_graphs([dataset.get_graph(i) for i in range(n)]).to(device)
    with precision_scope("exact"):
        logits = single.model(batch, train=True)
        loss = weighted_cross_entropy(logits, batch.labels, single.class_weights,
                                      batch.node_mask)
        grads = torch.autograd.grad(loss, single.model.jax_parameters())
    local = n // 2
    logit_err = max(within(torch.from_numpy(r["dp_logits"]),
                           logits[i * local:(i + 1) * local].detach().cpu())
                    for i, r in enumerate(ranks))
    grad_err = max(within(torch.from_numpy(r[f"dp_grad/{j}"]), g.cpu())
                   for r in ranks for j, g in enumerate(grads))
    check(str(ranks[0]["backend"]) == "gloo",
          f"two ranks on one device ran over {ranks[0]['backend']}")
    check(logit_err <= DIST_LOGIT_TOL and grad_err <= DIST_GRAD_TOL,
          f"DP against one device: logits {logit_err:.3g}, gradients "
          f"{grad_err:.3g} of their largest entries")
    check(abs(float(ranks[0]["dp_loss"]) - loss.item()) <= 1e-5 * abs(loss.item()),
          f"DP loss {float(ranks[0]['dp_loss'])} against {loss.item()}")
    feats, src, dst, labels, _, _ = union_samples(
        [dataset.get_sample(i) for i in range(n)])
    union = graph_from_arrays(feats, src, dst, labels, rslot=True).to(device)
    from gnn_tumor_seg_tpu_torch.parallel.halo import place_partition
    from gnn_tumor_seg_tpu_torch.parallel.mesh import Mesh

    check(bool(ranks[0]["staged"]) == (device == "cuda"),
          "the two-rank gloo world on the card did not stage its exchange")
    want = {}
    for model_type in ("GSpool", "GAT"):
        model = init_graph_net(model_type, _train_hp(model_type),
                               torch.Generator().manual_seed(SEED)).to(device)
        cw = torch.tensor(_train_hp(model_type).class_weights, device=device)
        with precision_scope("exact"):
            u_logits = model(union, train=True)
            u_loss = weighted_cross_entropy(u_logits, union.labels, cw,
                                            union.node_mask)
            u_grads = torch.autograd.grad(u_loss, model.jax_parameters())
        want[model_type] = (model, u_logits.detach().cpu(), u_loss.item(),
                            [g.cpu() for g in u_grads])
    halo_err, nbytes, single_ms, halo_tables = {}, {}, {}, []
    for variant in ("p2p", "all_gather"):
        (batches,), _, w = build_partitioned_sets(dataset, 2, n, variant,
                                                  [list(range(n))])
        b = batches[0]
        for model_type in ("GSpool", "GAT"):
            key = f"{model_type}/{variant}"
            model, u_logits, u_loss, u_grads = want[model_type]
            got = unpermute_nodes(np.stack([r[f"halo/{key}"] for r in ranks]),
                                  b.n_total)
            err = {"logits": within(torch.from_numpy(got),
                                    u_logits[0, :b.n_total]),
                   "loss": max(abs(float(r[f"halo_loss/{key}"]) - u_loss)
                               for r in ranks) / abs(u_loss),
                   "grads": max(within(torch.from_numpy(r[f"halo_grad/{key}/{j}"]), g)
                                for r in ranks for j, g in enumerate(u_grads))}
            halo_err[key] = err
            check(err["logits"] <= DIST_LOGIT_TOL and err["loss"] <= 1e-5
                  and err["grads"] <= DIST_GRAD_TOL,
                  f"halo {model_type} {variant} against one device on the "
                  f"union: own-row logits {err['logits']:.3g}, loss "
                  f"{err['loss']:.3g}, gradients {err['grads']:.3g} of their "
                  f"largest entries")
            nbytes[key] = {
                "f32": exchange_bytes_per_step(model, b.pg, variant, w, 4),
                "bf16": exchange_bytes_per_step(model, b.pg, variant, w, 2)}
        for r in ((0, 1) if variant == "p2p" else (0,)):
            rank = Mesh(world_size=2, rank=r, device=torch.device(device),
                        backend="gloo", n_data=2)
            halo_tables.append((f"{variant} rank {r}",
                                place_partition(b.pg, rank, w).table))
    table_err = check_kernels_on_halo_tables(torch.device(device), halo_tables)
    log(f"[dist] exact parity: DP logits {logit_err:.3g}, gradients "
        f"{grad_err:.3g} (tolerances {DIST_LOGIT_TOL}, {DIST_GRAD_TOL}); halo "
        f"own-row logits, loss and summed gradients (p2p staged through host "
        f"memory) {json.dumps({k: {m: float(f'{x:.3g}') for m, x in v.items()} for k, v in halo_err.items()})} "
        f"of the largest, union of {n} graphs ({len(feats)} nodes); card: {card}")
    for k, v in nbytes.items():
        log(f"[dist] exchange {k} per rank and step (analytic): f32 "
            f"{v['f32']['step_bytes_per_device']} B, bf16 "
            f"{v['bf16']['step_bytes_per_device']} B, rows a layer "
            f"{v['f32']['rows_exchanged_per_layer']}, widths "
            f"{v['f32']['layer_widths']}")
    timing = {}
    if timed:
        single_ms["GSpool/batch6"] = _time_single_step("GSpool", batch, device)
        for model_type in ("GSpool", "GAT"):
            single_ms[f"{model_type}/union"] = _time_single_step(
                model_type, union, device)
        timing = {"dp_2rank_ms": float(np.median(ranks[0]["dp_step_ms"])),
                  "single_batch6_ms": single_ms["GSpool/batch6"]}
        for key in ranks[0]:
            if key.startswith("halo_step_ms/"):
                timing[key.replace("halo_step_ms/", "halo_2rank_ms/")] = \
                    float(np.median(ranks[0][key]))
        for mt in ("GSpool", "GAT"):
            timing[f"single_union_ms/{mt}"] = single_ms[f"{mt}/union"]
        log("[dist] fast step, median of " f"{DIST_TIMED_STEPS} (ms; two ranks "
            "share one card over gloo with host-staged exchanges, so these are "
            "no scaling numbers): " + json.dumps(
                {k: round(v, 3) for k, v in timing.items()}) + f"; card: {card}")
    launches = dict(NO_LAUNCHES)
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] += v
    log(f"[dist] phase 9: {len(runs)} CLI runs at once in {t_cli:.1f} s, whole phase "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return {"runs": runs, "launches": launches, "timing": timing,
            "bytes": nbytes, "halo_err": halo_err, "table_err": table_err,
            "dp_err": {"logits": logit_err, "grads": grad_err}}


# ---------------------------------------------------------------------------
# phase 10: tensor parallelism, two model ranks on the one card
# ---------------------------------------------------------------------------

TP_BATCH = 2              # graphs of the training shape in the parity batch


def tp_collective_bytes(model_type, B, N, n_model, nbytes) -> dict:
    """Analytic bytes a rank receives over its model group in one training
    step of `model_type` at the training configuration, B graphs of N rows,
    activations of `nbytes`: an all-gather of a [B, N, W] tensor brings
    (M - 1) / M of it, a ring all-reduce of one 2 (M - 1) / M. A GSpool
    layer (in a, out b) gathers its aggregate (a % M == 0) and its output
    (b % M == 0) and all-reduces the gradient of its input (either split)
    and of its aggregate (b split); a GAT layer whose heads divide gathers
    its [B, N, H*F] output and all-reduces its input's gradient."""
    from gnn_tumor_seg_tpu_torch.models.factory import init_graph_net

    model = init_graph_net(model_type, _train_hp(model_type))
    frac = (n_model - 1) / n_model
    gather = reduce = 0.0
    for layer in model.layers:
        if model_type == "GAT":
            if layer.num_heads % n_model == 0:
                gather += frac * layer.w.shape[1]
                reduce += 2 * frac * layer.w.shape[0]
            continue
        a, b = layer.w_self.shape
        pool, out = a % n_model == 0, b % n_model == 0
        gather += frac * (a * pool + b * out)
        reduce += 2 * frac * (a * (pool or out) + a * out)
    scale = B * N * nbytes
    return {"all_gather_bytes": int(gather * scale),
            "all_reduce_bytes": int(reduce * scale),
            "step_bytes_per_rank": int((gather + reduce) * scale)}


def _tp_parity_rank(rank, world, init, data_dir, out_dir, device, timed):
    """A rank of the (1, 2) mesh. In "exact", through ParallelGNNTrainer's
    own loss_and_grads, for GSpool [256]*6 and the hardcoded GAT on the
    first TP_BATCH graphs: the loss, the logits, the gradients gathered
    whole and each rank's launches. With `timed`, the fast step."""
    sys.path.insert(0, ROOT)
    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.parallel.collectives import (gather_leaf,
                                                              launches_by_rank)
    from gnn_tumor_seg_tpu_torch.parallel.dp import ParallelGNNTrainer
    from gnn_tumor_seg_tpu_torch.parallel.mesh import initialize_multihost, shutdown

    mesh = initialize_multihost(init, world, rank, device=device, n_model=world,
                                timeout_s=120)
    dev = mesh.device
    out = {"backend": np.asarray(mesh.backend), "staged": np.asarray(mesh.staged)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        dataset = ImageGraphDataset(data_dir, read_image=False)
        for model_type in ("GSpool", "GAT"):
            hp = _train_hp(model_type)
            hp.batch_size = TP_BATCH
            tr = ParallelGNNTrainer(model_type, hp, dataset, seed=SEED, mesh=mesh,
                                    precision="exact")
            n_pad, d_pad = tr._shape_budget
            batch = batch_graphs([dataset.get_graph(i) for i in range(TP_BATCH)],
                                 n_pad=n_pad, d_pad=d_pad).to(dev)
            with launches_by_rank(mesh) as counts, precision_scope("exact"):
                loss = tr.loss_and_grads(batch)
                sync()
            out[f"{model_type}/launches"] = np.asarray(json.dumps(counts))
            out[f"{model_type}/loss"] = np.float64(loss.item())
            with torch.no_grad(), precision_scope("exact"):
                out[f"{model_type}/logits"] = tr.model(batch, train=True).cpu().numpy()
            for i, (p, ax) in enumerate(zip(tr.model.jax_parameters(), tr._tp_axes)):
                g = p.grad if ax is None else gather_leaf(p.grad, ax, mesh)
                out[f"{model_type}/grad/{i}"] = g.cpu().numpy()
            out[f"{model_type}/axes"] = np.asarray(
                [-1 if a is None else a for a in tr._tp_axes])
            if timed:
                gen = torch.Generator(device=dev).manual_seed(SEED)
                ms = []
                for i in range(DIST_TIMED_STEPS + 2):
                    sync()
                    t = time.perf_counter()
                    with precision_scope("fast"):
                        tr._step(batch, gen)
                    sync()
                    if i >= 2:
                        ms.append((time.perf_counter() - t) * 1e3)
                out[f"{model_type}/step_ms"] = np.asarray(ms)
            del tr, batch
        np.savez(os.path.join(out_dir, f"tp_r{rank}.npz"), **out)
    finally:
        shutdown()


def phase_train_tp(data_dir: str, tmp: str, card: str, device="cuda") -> dict:
    """Tensor parallelism on the one card (mesh (1, 2): two model ranks,
    gloo, staged through host memory): `cli.train_gnn --parallel dp --mesh
    1,2 -m GSpool` for 2 fast epochs, started alongside a parity world of
    its own in which GSpool [256]*6 and the hardcoded GAT, through
    ParallelGNNTrainer.loss_and_grads in "exact" on TP_BATCH graphs of the
    training shape, give logits within DIST_LOGIT_TOL, a loss within 1e-6
    relative and gathered gradients within DIST_GRAD_TOL of one device's on
    the same batch, each rank launching every kernel of the step. On the
    card, each model's fast step (median of DIST_TIMED_STEPS) beside one
    device's, and the analytic bytes of the model-group collectives."""
    import torch.multiprocessing as mp

    from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset
    from gnn_tumor_seg_tpu_torch.ops.graph import batch_graphs
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.parallel.mesh import free_port
    from gnn_tumor_seg_tpu_torch.train.gnn_trainer import GNNTrainer
    from gnn_tumor_seg_tpu_torch.train.losses import weighted_cross_entropy

    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "tp_logs")
    par_dir = os.path.join(tmp, "tp_parity")
    os.makedirs(out_dir)
    os.makedirs(par_dir)
    run = "tp_1x2"
    argv = dist_cli_argv(data_dir, out_dir, run, "GSpool", "dp", "1,2",
                         DIST_EPOCHS, device, None)
    log_path = os.path.join(out_dir, f"{run}.out")
    started = {run: (start_dist_run(argv, 2, False, log_path), log_path)}
    timed = device == "cuda"
    try:
        ctx = mp.start_processes(
            _tp_parity_rank, nprocs=2, join=False, start_method="spawn",
            args=(2, f"tcp://localhost:{free_port()}", data_dir, par_dir, device,
                  timed))
        end = time.perf_counter() + DIST_DEADLINE_S
        try:
            while not ctx.join(timeout=1.0):
                check(time.perf_counter() < end,
                      f"TP parity ranks still running after {DIST_DEADLINE_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    finally:
        wait_dist_runs(started, DIST_DEADLINE_S)
    t_world = time.perf_counter() - t0
    cli = check_dist_run(data_dir, out_dir, run, "GSpool", 2, DIST_EPOCHS, card,
                         device, "GSpool --parallel dp --mesh 1,2 (tensor "
                         "parallelism: 2 model ranks)")
    ranks = [dict(np.load(os.path.join(par_dir, f"tp_r{r}.npz"))) for r in range(2)]
    check(str(ranks[0]["backend"]) == "gloo" and
          bool(ranks[0]["staged"]) == (device == "cuda"),
          f"two model ranks on one device ran over {ranks[0]['backend']}, "
          f"staged {ranks[0]['staged']}")
    dataset = ImageGraphDataset(data_dir, read_image=False)
    errs, launches, timing, nbytes = {}, dict(NO_LAUNCHES), {}, {}
    for model_type in ("GSpool", "GAT"):
        hp = _train_hp(model_type)
        hp.batch_size = TP_BATCH
        single = GNNTrainer(model_type, hp, dataset, seed=SEED, precision="exact",
                            device=device)
        n_pad, d_pad = single._shape_budget
        batch = batch_graphs([dataset.get_graph(i) for i in range(TP_BATCH)],
                             n_pad=n_pad, d_pad=d_pad).to(device)
        with precision_scope("exact"):
            logits = single.model(batch, train=True)
            loss = weighted_cross_entropy(logits, batch.labels,
                                          single.class_weights, batch.node_mask)
            grads = [g.cpu() for g in torch.autograd.grad(
                loss, single.model.jax_parameters())]
        logits = logits.detach().cpu()
        err = {"logits": max(within(torch.from_numpy(r[f"{model_type}/logits"]),
                                    logits) for r in ranks),
               "loss": max(abs(float(r[f"{model_type}/loss"]) - loss.item())
                           for r in ranks) / abs(loss.item()),
               "grads": max(within(torch.from_numpy(r[f"{model_type}/grad/{j}"]), g)
                            for r in ranks for j, g in enumerate(grads))}
        errs[model_type] = err
        sharded = int((ranks[0][f"{model_type}/axes"] >= 0).sum())
        check(err["logits"] <= DIST_LOGIT_TOL and err["loss"] <= 1e-6
              and err["grads"] <= DIST_GRAD_TOL,
              f"TP {model_type} (1, 2) against one device: logits "
              f"{err['logits']:.3g}, loss {err['loss']:.3g} relative, gradients "
              f"{err['grads']:.3g} of their largest entries "
              f"({sharded} of {len(grads)} leaves sharded)")
        per_step = {k: (v if device == "cuda" else 0)
                    for k, v in dist_step_launches(model_type).items()}
        want = {**NO_LAUNCHES, **per_step}
        for r, counts in enumerate(json.loads(str(ranks[0][f"{model_type}/launches"]))):
            check(counts == want, f"TP {model_type} rank {r}: launches {counts}, "
                                  f"expected {want}")
            for k, v in counts.items():
                launches[k] += v
        nbytes[model_type] = {
            "f32": tp_collective_bytes(model_type, TP_BATCH, n_pad, 2, 4),
            "bf16": tp_collective_bytes(model_type, TP_BATCH, n_pad, 2, 2)}
        if timed:
            timing[f"tp_1x2_ms/{model_type}"] = float(
                np.median(ranks[0][f"{model_type}/step_ms"]))
            timing[f"single_ms/{model_type}"] = _time_single_step(
                model_type, batch, device)
        del single, batch, logits, grads
        log(f"[tp] {model_type} (1, 2), exact, through loss_and_grads: logits "
            f"{err['logits']:.3g}, loss {err['loss']:.3g}, gradients "
            f"{err['grads']:.3g} of one device's ({sharded} of "
            f"{len(ranks[0][f'{model_type}/axes'])} leaves sharded); per rank "
            f"{per_step}; card: {card}")
    for k, v in cli["launches"].items():
        launches[k] += v
    for k, v in nbytes.items():
        log(f"[tp] model-group collectives per rank and step (analytic, "
            f"B={TP_BATCH}, N={n_pad}, M=2): {k} f32 {json.dumps(v['f32'])}, "
            f"bf16 {json.dumps(v['bf16'])}")
    if timing:
        log("[tp] fast step, median of " f"{DIST_TIMED_STEPS} (ms; two ranks share "
            "one card over gloo with host-staged collectives, so these are no "
            "scaling numbers): " + json.dumps({k: round(v, 3)
                                               for k, v in timing.items()})
            + f"; card: {card}")
    log(f"[tp] phase 10: CLI run and parity world at once in {t_world:.1f} s, "
        f"whole phase {time.perf_counter() - t0:.1f} s; launches {launches}")
    return {"launches": launches, "errs": errs, "timing": timing,
            "bytes": nbytes, "cli": cli}


# ---------------------------------------------------------------------------
# phase 11: reference torch weights imported, then served
# ---------------------------------------------------------------------------


def reference_state_dicts(rng):
    """A DGL-layout GSpool state_dict (layers.{i}.fc_pool/fc_self/fc_neigh/
    bias, IN_FEATS -> GNN_WIDTHS -> 4) and a CnnRefinementNet one (8 -> 16
    -> 4, 5^3 kernels), torch tensors from seeded numpy at xavier / conv
    init scales; and the same arrays in the port's own layout ([in, out]
    Linear weights, DHWIO convolutions), transposed here."""
    def arr(shape, fan):
        return rng.normal(scale=fan ** -0.5, size=shape).astype(np.float32)

    dims = [IN_FEATS, *GNN_WIDTHS, 4]
    gnn_sd, gnn_params = {}, []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        w_pool, b_pool = arr((a, a), a), arr((a,), a)
        w_self, w_neigh, bias = arr((b, a), a), arr((b, a), a), arr((b,), a)
        pre = f"layers.{i}."
        gnn_sd.update({pre + "fc_pool.weight": w_pool, pre + "fc_pool.bias": b_pool,
                       pre + "fc_self.weight": w_self,
                       pre + "fc_neigh.weight": w_neigh, pre + "bias": bias})
        gnn_params.append({"w_pool": w_pool.T, "b_pool": b_pool,
                           "w_self": w_self.T, "w_neigh": w_neigh.T, "bias": bias})
    w0, b0 = arr((16, 8, 5, 5, 5), 8 * 125), arr((16,), 8 * 125)
    w1, b1 = arr((4, 16, 5, 5, 5), 16 * 125), arr((4,), 16 * 125)
    cnn_sd = {"conv_layers.0.weight": w0, "conv_layers.0.bias": b0,
              "conv_layers.1.weight": w1, "conv_layers.1.bias": b1}
    cnn_params = {"conv0": {"w": w0.transpose(2, 3, 4, 1, 0), "b": b0},
                  "conv1": {"w": w1.transpose(2, 3, 4, 1, 0), "b": b1}}
    as_torch = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}  # noqa: E731
    return as_torch(gnn_sd), gnn_params, as_torch(cnn_sd), cnn_params


def phase_import_serve(inputs, card, device="cuda", num_nodes=NUM_NODES,
                       shape=BRAIN_SHAPE) -> dict:
    """Reference torch weights into a serve request: the two state_dicts of
    reference_state_dicts saved with torch.save and converted by
    `python -m gnn_tumor_seg_tpu_torch.cli.import_torch_weights` (two
    commands at once); then one exact predict_single_mri request on the
    brain of `inputs` with the imported checkpoints (7 max_agg launches),
    whose labels must lie in {0, 1, 2, 4} and equal bitwise those of a
    request with checkpoints written by save_checkpoint straight from the
    same arrays; then viz.helpers.load_plotting_data on that prediction,
    numpy only (no matplotlib imported)."""
    from gnn_tumor_seg_tpu_torch.cli.common import (load_cnn_from_checkpoint,
                                                    load_gnn_from_checkpoint,
                                                    resolve_slic_fn)
    from gnn_tumor_seg_tpu_torch.cli.predict_single import predict_single_mri
    from gnn_tumor_seg_tpu_torch.config import HyperParams
    from gnn_tumor_seg_tpu_torch.convert import cnn_params_from_jax, gnn_params_from_jax
    from gnn_tumor_seg_tpu_torch.data import nifti
    from gnn_tumor_seg_tpu_torch.ops.precision import precision_scope
    from gnn_tumor_seg_tpu_torch.train.checkpoint import save_checkpoint
    from gnn_tumor_seg_tpu_torch.viz.helpers import load_plotting_data

    t0 = time.perf_counter()
    in_dir = inputs[0]
    d = os.path.join(os.path.dirname(in_dir), "import")
    os.makedirs(d)
    gnn_sd, gnn_params, cnn_sd, cnn_params = reference_state_dicts(
        np.random.default_rng(SEED + 11))
    ckpts = {"imported": {}, "direct": {}}
    procs = []
    for name, sd, model_type in (("gnn", gnn_sd, "GSpool"), ("cnn", cnn_sd, "CNN")):
        pt = os.path.join(d, f"{name}.pt")
        torch.save(sd, pt)
        ckpts["imported"][name] = os.path.join(d, f"{name}_imported.ckpt")
        cmd = [sys.executable, "-m", "gnn_tumor_seg_tpu_torch.cli.import_torch_weights",
               "-i", pt, "-o", ckpts["imported"][name], "-t", model_type]
        procs.append((cmd, subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    hp = HyperParams(in_feats=IN_FEATS, out_classes=4, layer_sizes=list(GNN_WIDTHS))
    ckpts["direct"]["gnn"] = os.path.join(d, "gnn_direct.ckpt")
    save_checkpoint(ckpts["direct"]["gnn"], gnn_params_from_jax(gnn_params),
                    "GSpool", hp)
    ckpts["direct"]["cnn"] = os.path.join(d, "cnn_direct.ckpt")
    save_checkpoint(ckpts["direct"]["cnn"], cnn_params_from_jax(cnn_params), "CNN",
                    HyperParams(in_feats=8, out_classes=4, layer_sizes=[16],
                                batch_size=1))
    for cmd, proc in procs:
        text, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"{' '.join(cmd[2:4])} exited "
                                    f"{proc.returncode}:\n{text[-3000:]}")
        log(f"[import] {text.strip().splitlines()[-1]}")
    t_import = time.perf_counter() - t0
    preds, launches = {}, dict(NO_LAUNCHES)
    for which, paths in ckpts.items():
        gnn, _, gnn_forward = load_gnn_from_checkpoint(paths["gnn"], device=device)
        _, _, cnn_forward = load_cnn_from_checkpoint(paths["cnn"], device=device)
        read = _reset_counts()
        t = time.perf_counter()
        with precision_scope("exact"):
            pred = predict_single_mri(in_dir, gnn_forward, cnn_forward,
                                      num_nodes=num_nodes,
                                      slic_fn=resolve_slic_fn("native"))
        wall = time.perf_counter() - t
        counts = read()
        for k, v in counts.items():
            launches[k] += v
        if torch.device(device).type == "cuda":
            check(counts == {**NO_LAUNCHES, "max_agg": gnn.num_layers},
                  f"{which} request launched {counts}")
        labels = set(np.unique(pred).tolist())
        check(pred.shape == tuple(shape) and labels <= {0, 1, 2, 4},
              f"{which} request: {pred.shape}, labels {labels}")
        preds[which] = pred
        log(f"[import] {which} checkpoints: exact request {wall:.3f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }, labels {sorted(labels)}; "
            f"card: {card}")
    differ = int((preds["imported"] != preds["direct"]).sum())
    check(differ == 0, f"imported-weights labels differ from the directly "
                       f"written ones in {differ} voxels")
    seg_dir = os.path.join(d, "preds")
    os.makedirs(seg_dir)
    mri_id = os.path.basename(in_dir)
    nifti.save_as_nifti(preds["imported"], os.path.join(seg_dir, f"{mri_id}.nii.gz"))
    mod1, mod2, overlay, _ = load_plotting_data(os.path.dirname(in_dir), seg_dir,
                                                mri_id, read_labels=False)
    zoomed = (190, 190, shape[2]) if min(shape[:2]) >= 220 else tuple(shape)
    check(mod1.shape == zoomed and overlay.shape == zoomed + (3,),
          f"plotting data {mod1.shape}, overlay {overlay.shape}")
    check(not any(m.split(".")[0] == "matplotlib" for m in sys.modules),
          "viz.helpers.load_plotting_data imported matplotlib")
    log(f"[import] labels of the imported checkpoints bitwise those of the "
        f"directly written ones; overlay {overlay.shape} with numpy only; "
        f"imports {t_import:.1f} s, phase 11 {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "seconds": time.perf_counter() - t0}



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import gnn_tumor_seg_tpu_torch  # noqa: F401  (fails outside a checkout)

    with contextlib.ExitStack() as stack:
        return run_phases(stack)


def run_phases(stack: contextlib.ExitStack) -> int:
    """Every phase in order; temporary directories close with `stack`."""
    t_all = time.perf_counter()

    def done(phases):
        log(f"[time] {phases} done at {time.perf_counter() - t_all:.1f} s")

    env = phase_environment()
    card = env["card"]
    phase_build()
    done("phases 1-2")
    dev = torch.device("cuda")
    worst = phase_kernel_check(dev)
    train_worst = phase_train_kernel_check(dev)
    gat_worst = phase_gat_kernel_check(dev)
    dec_worst = phase_decomposed_kernel_check(dev)
    check_gat_dropout_trains(dev)
    done("phase 3")
    serve_tmp = stack.enter_context(
        tempfile.TemporaryDirectory(prefix="gts_smoke_serve_"))
    inputs = write_inputs(serve_tmp, BRAIN_SHAPE)
    serve = phase_serve("cuda", card=card, inputs=inputs)
    done("phase 4")
    deviceprep = phase_serve_deviceprep("cuda", inputs, card,
                                        host_run=serve["profile"])
    done("phase 4b")
    timing = phase_timing(serve["graph"], card)
    done("phase 5")
    worst = max(worst, timing["max_abs_err"], train_worst["max_agg"])
    with tempfile.TemporaryDirectory(prefix="gts_smoke_train_") as tmp:
        train = phase_train(tmp, card)
        prep = phase_preprocess_weighted(tmp, card)
        bulk = phase_preprocess_device(tmp, card, prep["preprocess_s"])
        weighted = phase_train_weighted(tmp, card)
        from gnn_tumor_seg_tpu_torch.data.dataset import ImageGraphDataset

        dataset = ImageGraphDataset(train["data_dir"], read_image=False)
        wdataset = ImageGraphDataset(weighted["data_dir"], read_image=False)
        drop = phase_train_gat_dropout(dataset, card)
        done("phase 6")
        step = time_train_steps(dataset, card)
        ttime = phase_train_timing(dataset, card)
        gat_step = time_train_steps(dataset, card, "GAT")
        gtime = phase_gat_timing(dataset, card)
        wstep = time_train_steps(wdataset, card, "GSmean")
        drop_step = time_train_steps(dataset, card, "GAT", attn_drop=GAT_ATTN_DROP)
        dtime = phase_decomposed_timing(dataset, card)
        # last, so that the cells timed before it run as they did without it
        mean_step = time_train_steps(dataset, card, "GSmean")
        done("phase 7")
        pipe = phase_pipeline(tmp, card)
        done("phase 8")
        dist = phase_train_dist(train["data_dir"], tmp, card)
        done("phase 9")
        tp = phase_train_tp(train["data_dir"], tmp, card)
    done("phase 10")
    imported = phase_import_serve(inputs, card)
    done("phase 11")
    paths = {"train": train["runs"], "preprocess_weighted": {"prep": prep["run"]},
             "train_weighted": weighted["runs"], "train_gat_attndrop": drop["runs"]}
    by_path = {path: {k: sum(r["counts"][k] for r in runs.values())
                      for k in NO_LAUNCHES} for path, runs in paths.items()}
    by_path["train_dist"] = dist["launches"]
    by_path["train_tp"] = tp["launches"]
    train_launches = {k: sum(c[k] for c in by_path.values()) for k in NO_LAUNCHES}
    dl, tl = dist["launches"], tp["launches"]
    one_dev = {k: train_launches[k] - dl[k] - tl[k] for k in NO_LAUNCHES}
    il = imported["launches"]
    for k, n in train_launches.items():
        check(n > 0, f"{k} was never launched on the training paths")
    rows = ttime["rows"]
    wide, narrow = TRAIN_WIDTHS[0], IN_FEATS
    layers = [(narrow, 1), (wide, len(TRAIN_WIDTHS))]
    f32 = timing["rows"]["float32"]
    gspool_step = {k: per_step(rows, [(k, F, n) for F, n in layers])
                   for k in ("max_agg", "max_agg_bwd")}
    gsmean_parts = [("sum_agg_mean", narrow, 1), ("sum_agg_mean", wide, 6),
                    ("sum_agg", wide, 6)]
    gsmean_step = per_step(rows, gsmean_parts)
    table = f"B={ttime['B']}, N={ttime['N']}, D={ttime['D']}"
    kernels = [{
        "name": "max_agg",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/max_agg.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:135",
        "launches": (serve["launches"] + deviceprep["launches"]["max_agg"]
                     + train_launches["max_agg"] + pipe["launches"]["max_agg"]
                     + il["max_agg"]),
        "launches_by_path": {"serve": serve["launches"],
                             "serve_deviceprep": deviceprep["launches"]["max_agg"],
                             "train": one_dev["max_agg"],
                             "train_dist": dl["max_agg"],
                             "train_tp": tl["max_agg"],
                             "pipeline": pipe["launches"]["max_agg"],
                             "serve_imported": il["max_agg"]},
        "max_abs_err": worst,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": f32["library_ms"],
        "per": ("one serve request, exact mode: 1 launch at F=20 + 6 at "
                f"F=256, N={timing['N']}, D={timing['D']}, arg store skipped; "
                "device time from CUDA-graph replay; library: "
                "F.embedding_bag(mode='max')"),
        "eager_ms": f32["eager_ms"],
        "fast_bf16": timing["rows"]["bfloat16"],
        "train_step_f32_with_arg": gspool_step["max_agg"],
        "train_step_bf16_with_arg": per_step(rows, [("max_agg", F, n)
                                                    for F, n in layers], "bfloat16"),
        "tp_shapes": tp_rows(rows, "max_agg"),
    }, {
        "name": "max_agg_bwd",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/max_agg.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:200",
        "launches": train_launches["max_agg_bwd"] + pipe["launches"]["max_agg_bwd"],
        "launches_by_path": {"train": one_dev["max_agg_bwd"],
                             "train_dist": dl["max_agg_bwd"],
                             "train_tp": tl["max_agg_bwd"],
                             "pipeline": pipe["launches"]["max_agg_bwd"]},
        "max_abs_err": train_worst["max_agg_bwd"],
        **gspool_step["max_agg_bwd"],
        "bound_by": "bytes",
        "per": (f"one GSpool training step, f32: 1 launch at F=20 + 6 at F=256, "
                f"{table}; library: the backward alone of "
                "F.embedding_bag(mode='max') (aten._embedding_bag_dense_backward)"),
        "fast_bf16": per_step(rows, [("max_agg_bwd", F, n) for F, n in layers],
                              "bfloat16"),
        "tp_shapes": tp_rows(rows, "max_agg_bwd"),
    }, {
        "name": "sum_agg",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/sum_agg.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:68",
        "launches": train_launches["sum_agg"],
        "max_abs_err": train_worst["sum_agg"],
        **gsmean_step,
        "bound_by": "bytes",
        "per": (f"one GSmean training step, f32: mean at F=20 + 6 mean at F=256 "
                f"(forward) + 6 sum at F=256 (backward), {table}; library: "
                "F.embedding_bag(mode='mean'/'sum', padding_idx)"),
        "fast_bf16": per_step(rows, gsmean_parts, "bfloat16"),
        "gsmean_step": {mode: {"step_ms": row["step_ms"],
                               "busy_ms_3_steps": row["profile"]["busy_ms"],
                               "idle_share": row["profile"]["idle_share"]}
                        for mode, row in mean_step.items()},
    }]
    gtable = f"B={gtime['B']}, N={gtime['N']}, D={gtime['D']}"
    gat_desc = ("hardcoded GAT, (H, F, activation, residual) per layer: "
                + ", ".join(map(str, gtime["layers"])))
    kernels += [{
        "name": "gat_fwd",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/fused_gat.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/fused_gat.py:103",
        "launches": (serve["gat"]["launches"] + deviceprep["launches"]["gat_fwd"]
                     + train_launches["gat_fwd"]),
        "launches_by_path": {"serve": serve["gat"]["launches"],
                             "serve_deviceprep": deviceprep["launches"]["gat_fwd"],
                             "train": one_dev["gat_fwd"],
                             "train_dist": dl["gat_fwd"],
                             "train_tp": tl["gat_fwd"]},
        "max_abs_err": gat_worst["abs"]["gat_fwd"],
        "max_rel_err": gat_worst["rel"]["gat_fwd"],
        **gat_per_step(gtime, "gat_fwd"),
        "bound_by": "bytes",
        "per": (f"one GAT training step, f32, alpha and sign mask stored: "
                f"{gat_desc}, {gtable}; library (partial): the combine "
                "alone, F.embedding_bag(mode='sum', per_sample_weights=alpha)"),
        "serve_variant_f32": gat_per_step(gtime, "gat_fwd_serve"),
        "fast_bf16": gat_per_step(gtime, "gat_fwd", "bfloat16"),
        "tp_shapes": gat_tp_rows(gtime, "gat_fwd"),
    }, {
        "name": "gat_bwd",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/fused_gat.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/fused_gat.py:186",
        "launches": train_launches["gat_bwd"],
        "launches_by_path": {"train": one_dev["gat_bwd"],
                             "train_dist": dl["gat_bwd"],
                             "train_tp": tl["gat_bwd"]},
        "max_abs_err": gat_worst["abs"]["gat_bwd"],
        "max_rel_err": gat_worst["rel"]["gat_bwd"],
        **gat_per_step(gtime, "gat_bwd"),
        "bound_by": "bytes",
        "per": (f"one GAT training step, f32: {gat_desc}, {gtable}; library "
                "(partial): d_alpha alone, "
                "aten._embedding_bag_per_sample_weights_backward over alpha's bags"),
        "fast_bf16": gat_per_step(gtime, "gat_bwd", "bfloat16"),
        "tp_shapes": gat_tp_rows(gtime, "gat_bwd"),
    }, {
        "name": "gat_rev",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/fused_gat.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/fused_gat.py:238",
        "launches": train_launches["gat_rev"],
        "launches_by_path": {"train": one_dev["gat_rev"],
                             "train_dist": dl["gat_rev"],
                             "train_tp": tl["gat_rev"]},
        "max_abs_err": gat_worst["abs"]["gat_rev"],
        **gat_per_step(gtime, "gat_rev"),
        "bound_by": "bytes",
        "per": (f"one GAT training step, f32: {gat_desc}, {gtable}; library "
                "(partial): d_z alone, aten._embedding_bag_dense_backward over "
                "alpha's bags"),
        "fast_bf16": gat_per_step(gtime, "gat_rev", "bfloat16"),
        "tp_shapes": gat_tp_rows(gtime, "gat_rev"),
    }]
    dtable = f"B={dtime['B']}, N={dtime['N']}, D={dtime['D']}"
    wsum_step = [(("wsum", 1, IN_FEATS), 1),
                 (("wsum", 1, TRAIN_WIDTHS[0]), len(TRAIN_WIDTHS))]
    wsum_bwd_step = [(("wsum_bwd", 1, TRAIN_WIDTHS[0]), len(TRAIN_WIDTHS))]
    glayers = gtime["layers"]

    def drop_step_parts(kname):
        if kname.startswith("slot_gather"):
            return [((kname, h), 1) for h, _, _, _ in glayers]
        return [((kname, h, f), 1) for h, f, _, _ in glayers]

    def dec_launches(k):
        return {"launches": train_launches[k],
                "launches_by_path": {p: c[k] for p, c in by_path.items() if c[k]}}

    gsmean_desc = (f"one weighted GSmean [256]*6 training step, f32: 1 launch at "
                   f"(H,F)=(1,{IN_FEATS}) + 6 at (1,{TRAIN_WIDTHS[0]}), {dtable}")
    drop_desc = (f"one GAT training step with attention dropout, f32: {gat_desc}, "
                 f"{dtable}")
    kernels += [{
        "name": "wsum",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/weighted_sum.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/weighted_sum.py:86",
        **dec_launches("wsum"),
        "max_abs_err": dec_worst["abs"]["wsum"],
        **dec_per_step(dtime, wsum_step),
        "bound_by": "bytes",
        "per": (f"{gsmean_desc}; library: aten._embedding_bag (mode sum, "
                "per-sample weights)"),
        "gat_attndrop_step_f32": dec_per_step(dtime, drop_step_parts("wsum")),
        "fast_bf16": dec_per_step(dtime, wsum_step, "bfloat16"),
    }, {
        "name": "wsum_bwd",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/weighted_sum.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/weighted_sum.py:86",
        **dec_launches("wsum_bwd"),
        "max_abs_err": dec_worst["abs"]["wsum_bwd"],
        **dec_per_step(dtime, wsum_bwd_step),
        "bound_by": "bytes",
        "per": (f"one weighted GSmean [256]*6 training step, f32: 6 launches at "
                f"(1,{TRAIN_WIDTHS[0]}), reverse weights read through rslot, "
                f"{dtable}; library: aten._embedding_bag_dense_backward (mode "
                "sum, per-sample weights)"),
        "gat_attndrop_step_f32": dec_per_step(dtime, drop_step_parts("wsum_bwd")),
        "fast_bf16": dec_per_step(dtime, wsum_bwd_step, "bfloat16"),
    }, {
        "name": "pairdot",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/weighted_sum.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/weighted_sum.py:144",
        **dec_launches("pairdot"),
        "max_abs_err": dec_worst["abs"]["pairdot"],
        "max_rel_err": dec_worst["rel"]["pairdot"],
        **dec_per_step(dtime, drop_step_parts("pairdot")),
        "bound_by": "bytes",
        "per": (f"{drop_desc}; library: "
                "aten._embedding_bag_per_sample_weights_backward"),
        "fast_bf16": dec_per_step(dtime, drop_step_parts("pairdot"), "bfloat16"),
    }, {
        "name": "slot_gather",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/slot_gather.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/slot_gather.py:58",
        **dec_launches("slot_gather"),
        "max_abs_err": dec_worst["abs"]["slot_gather"],
        **dec_per_step(dtime, drop_step_parts("slot_gather")),
        "bound_by": "bytes",
        "per": f"{drop_desc} (W = heads); library: F.embedding",
        "fast_bf16": dec_per_step(dtime, drop_step_parts("slot_gather"), "bfloat16"),
    }, {
        "name": "slot_gather_bwd",
        "route": "cuda",
        "source": "gnn_tumor_seg_tpu_torch/ops/kernels/csrc/slot_gather.cu",
        "replaces": "gnn_tumor_seg_tpu/ops/pallas/slot_gather.py:58",
        **dec_launches("slot_gather_bwd"),
        "max_abs_err": dec_worst["abs"]["slot_gather_bwd"],
        **dec_per_step(dtime, drop_step_parts("slot_gather_bwd")),
        "bound_by": "bytes",
        "per": (f"{drop_desc} (W = heads); library: "
                "aten.embedding_dense_backward"),
        "fast_bf16": dec_per_step(dtime, drop_step_parts("slot_gather_bwd"),
                                  "bfloat16"),
    }]
    check(serve["gat"]["launches"] > 0, "gat_fwd was never launched on the serve path")
    for k in ("max_agg", "gat_fwd"):
        check(deviceprep["launches"][k] > 0,
              f"{k} was never launched on the device-prep serve path")
    chain = deviceprep["chain"]
    log("[deviceprep] " + json.dumps({
        "chain_device_ms": chain["total_ms"],
        "parts_ms_launches": chain["parts"],
        "assign_pass_ms": chain["assign_pass_ms"],
        "assign_pass_bound_ms": chain["assign_bound_ms"],
        "request_idle_share": {"device_prep": deviceprep["device_prep"]["idle_share"],
                               "host_prep": deviceprep["host_prep"]["idle_share"]},
        "bulk_2mri_s": bulk}))
    for label, st in (("step", step), ("GAT step", gat_step),
                      ("weighted GSmean step", wstep),
                      (f"GAT attn_drop={GAT_ATTN_DROP} step", drop_step),
                      ("GSmean step", mean_step)):
        log(f"[train] {label}: " + json.dumps(
            {mode: {k: v for k, v in row.items() if k != "profile"}
             for mode, row in st.items()}))
    log(f"[train] gradients through the kernels within {train['gat_grad_rel']:.3g} "
        f"(GAT) and {drop['grad_rel']:.3g} (GAT attn_drop) of the plain path's; "
        f"launches by path: {json.dumps(by_path)}")
    log("[tp] " + json.dumps({"errs": tp["errs"], "step_ms": tp["timing"],
                              "collective_bytes": tp["bytes"]}))
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
