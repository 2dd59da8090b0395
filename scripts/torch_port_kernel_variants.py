#!/usr/bin/env python3
"""Time variants of the PyTorch port's sum_agg, max_agg, max_agg_bwd,
slot_gather, wsum, wsum_bwd, gat_rev, gat_fwd and gat_bwd kernels on one
NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/torch_port_kernel_variants.py [--against DIR ...] [--gat | --agg]

sum_agg and max_agg: sum_agg.cu and max_agg.cu with their forward's
`kAggChunk` line (how many slots' vector loads a thread starts together)
set to 2, 4 or 8 and their `kAggMinBlocks` line (the launch bound: blocks
of 256 threads an SM that the registers must allow) set to 1, 4, 6 or 8,
each pair a build, beside the shipped source; sum_agg as sum and mean,
max_agg with the winner slot stored and as the serve variant, at F=20 and
256, float32 and bfloat16, on both tables below, each held bitwise to its
plain PyTorch version.

max_agg_bwd: gnn_tumor_seg_tpu_torch/ops/kernels/csrc/max_agg.cu with its
`kChunk` line (how many slots' loads a thread starts together) set to 1, 2,
4 or 8, or 4 at vectors of 4 and 1 or 2 at vectors of 8, each held bitwise
to the plain PyTorch version and timed at the
training shapes: B=6 graphs of N=8192 rows, F=20 and 256, float32 and
bfloat16, on the training cell's ring table (k=10, 7000 real nodes, D=12:
neighbours lie near each other in memory) and on a random symmetric table
(D=16: no locality). slot_gather: the kernel at W = 1, 2, 3, 4, 5, 12, 48
(chip_smoke.SLOT_WIDTHS) on the ring table, beside F.embedding and the
kernel that F.embedding launches there. The weighted combines:
weighted_sum.cu's wsum and wsum_bwd at the main path's (H,F)
(chip_smoke.DECOMPOSED_SHAPES) and fused_gat.cu's gat_rev at the hardcoded
GAT's, each with its `kChunk` line set to 2, 4, 8, or 4 at vectors of 8
and 2 elsewhere, on both tables, float32 and bfloat16, with random weights (alpha and d_pre for gat_rev) that are not
symmetric; each held bitwise to its plain PyTorch version. The fused GAT
forward (training variant, alpha and sign mask stored, and serve variant)
and backward at the hardcoded GAT's (H,F) and layer epilogues, with
fused_gat.cu's `kFwdChunk` or `kBwdChunk` line set to 2, 4, 8 or the
shipped value, its `kMaxRows` line (the rows a block takes at most) set
to 64 or 256, or the forward's `kFwdMinBlocks` (its launch bound, blocks
an SM) to 1, 6 or 8 for every type and width, on both tables, float32
and bfloat16: the forward held to its plain version within
chip_smoke.GAT_FWD_TOL (bf16 output: one ulp beyond it) with its sign
mask bitwise, the serve variant bitwise equal to the training one, the
backward within chip_smoke.GAT_BWD_TOL.

--gat times the three GAT kernels alone, --agg sum_agg and max_agg alone.
--against DIR (repeatable) builds DIR's copies of the five sources (for
example a `git archive` of another commit; their C interfaces must be
this checkout's) and times them beside these, named "against" for the
first DIR and "against:DIR" for the others. Sources are built with nvcc
for sm_90a into the port's _build/ directory; times are device ms per
call by CUDA-graph replay (chip_smoke.time_device). Prints the card,
ptxas' registers and spills per kernel, and one line of times per shape.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gnn_tumor_seg_tpu_torch.build import BUILD_DIR, build_cuda_library  # noqa: E402
from gnn_tumor_seg_tpu_torch.ops.graph import ell_from_edges, reciprocal_slots  # noqa: E402
from gnn_tumor_seg_tpu_torch.ops.kernels import (  # noqa: E402
    fused_gat, max_agg, slot_gather, sum_agg, weighted_sum)

# max_agg_bwd's kChunk values: constants, and per vector width (VEC = 8 at
# F=256, 4 at F=20)
CHUNKS = ("1", "2", "4", "8", "VEC == 8 ? 1 : 4", "VEC == 8 ? 2 : 4")
# the weighted combines' kChunk values (gat_rev ships the last, wsum the first)
COMBINE_CHUNKS = ("2", "4", "8", "VEC == 8 ? 4 : 2")
CHUNK_LINE = re.compile(r"constexpr int kChunk = [^;]+;")
# fused_gat.cu's forward and backward chunk lines and the values swept (the
# last of each is what ships)
FWD_CHUNKS = ("4", "8", "2")
FWD_CHUNK_LINE = re.compile(r"constexpr int kFwdChunk = [^;]+;")
BWD_CHUNKS = ("2", "4", "8", "VEC == 8 ? 4 : 2")
BWD_CHUNK_LINE = re.compile(r"constexpr int kBwdChunk = [^;]+;")
# the rows a forward or backward block takes at most (128 ships), and the
# forward's bound on registers as blocks an SM (8, or 6 at bfloat16's
# vectors of 8, ships)
MAX_ROWS = ("64", "256")
MAX_ROWS_LINE = re.compile(r"constexpr int kMaxRows = [^;]+;")
MIN_BLOCKS = ("1", "6", "8")
MIN_BLOCKS_LINE = re.compile(r"constexpr int kFwdMinBlocks = [^;]+;")
# sum_agg's and max_agg's forward chunk and launch-bound lines, swept as
# pairs
AGG_CHUNKS = ("2", "4", "8")
AGG_CHUNK_LINE = re.compile(r"constexpr int kAggChunk = [^;]+;")
AGG_MIN_BLOCKS = ("1", "4", "6", "8")
AGG_MIN_BLOCKS_LINE = re.compile(r"constexpr int kAggMinBlocks = [^;]+;")
CSRC = os.path.join("gnn_tumor_seg_tpu_torch", "ops", "kernels", "csrc")
VP, I32 = ctypes.c_void_p, ctypes.c_int


def build(stem: str, source: str) -> ctypes.CDLL:
    path = os.path.join(BUILD_DIR, stem + ".cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(source)
    lib, log = build_cuda_library(stem, path)
    for kern, regs, stores, loads in cs.ptxas_kernels(log):
        if any(k in kern for k in ("max_agg", "sum_agg", "slot_gather", "wsum", "gat_")):
            print(f"[build] {stem}: {kern}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B", flush=True)
    if hasattr(lib, "gts_sum_agg_f32"):
        fns, args = (lib.gts_sum_agg_f32, lib.gts_sum_agg_bf16), [VP] * 4 + [I32] * 5
    elif hasattr(lib, "gts_max_agg_bwd_f32"):
        for fn in (lib.gts_max_agg_f32, lib.gts_max_agg_bf16):
            fn.argtypes = [VP] * 5 + [I32] * 5 + [VP]
            fn.restype = I32
        fns, args = (lib.gts_max_agg_bwd_f32, lib.gts_max_agg_bwd_bf16), [VP] * 6 + [I32] * 4
    elif hasattr(lib, "gts_wsum_f32"):
        fns, args = (lib.gts_wsum_f32, lib.gts_wsum_bf16), [VP] * 6 + [I32] * 6
    elif hasattr(lib, "gts_gat_rev_f32"):
        for fn in (lib.gts_gat_fwd_f32, lib.gts_gat_fwd_bf16):
            fn.argtypes = [VP] * 10 + [I32] * 5 + [ctypes.c_float, I32, I32, VP]
            fn.restype = I32
        for fn in (lib.gts_gat_bwd_f32, lib.gts_gat_bwd_bf16):
            fn.argtypes = [VP] * 8 + [I32] * 5 + [ctypes.c_float, VP]
            fn.restype = I32
        fns, args = (lib.gts_gat_rev_f32, lib.gts_gat_rev_bf16), [VP] * 8 + [I32] * 5
    else:
        fns, args = (lib.gts_slot_gather_f32, lib.gts_slot_gather_bf16), [VP] * 4 + [I32] * 4
    for fn in fns:
        fn.argtypes = args + [VP]
        fn.restype = I32
    return lib


def build_all(against: list[str], only: str | None) -> dict:
    """Every variant, one nvcc each, all started together: {kind: {name:
    library}} for the kinds "sum" (sum_agg.cu) and "max" (max_agg.cu's
    forward), whose kAggChunk and kAggMinBlocks lines are swept as pairs,
    "bwd" (max_agg.cu's backward), "gather" (slot_gather.cu), "wsum"
    (weighted_sum.cu), and "rev", "fwd", "gbwd" and "rows" (fused_gat.cu,
    whose gat_rev, gat_fwd and gat_bwd chunk lines, its kMaxRows line and
    the forward's kFwdMinBlocks line are swept in turn); only the last four
    when `only` is "gat", only the first two when it is "agg"."""
    def read(path):
        with open(path) as f:
            return f.read()

    def chunked(kind, stem, path, chunks, line=CHUNK_LINE):
        source = read(path)
        if len(line.findall(source)) != 1:
            raise SystemExit(f"expected one {line.pattern} line in {path}")
        name = line.pattern.split()[2]
        return {(kind, f"{name}={c}"): (f"{stem}_{name}{i}", line.sub(
            f"constexpr int {name} = {c};", source)) for i, c in enumerate(chunks)}

    def agg_pairs(kind, stem, path):
        source = read(path)
        for line in (AGG_CHUNK_LINE, AGG_MIN_BLOCKS_LINE):
            if len(line.findall(source)) != 1:
                raise SystemExit(f"expected one {line.pattern} line in {path}")
        out = {(kind, "this"): (f"{stem}_this", source)}
        for i, c in enumerate(AGG_CHUNKS):
            for j, m in enumerate(AGG_MIN_BLOCKS):
                out[(kind, f"kAggChunk={c} kAggMinBlocks={m}")] = (
                    f"{stem}_agg{i}{j}", AGG_MIN_BLOCKS_LINE.sub(
                        f"constexpr int kAggMinBlocks = {m};", AGG_CHUNK_LINE.sub(
                            f"constexpr int kAggChunk = {c};", source)))
        return out

    jobs = {}
    if only != "agg":
        jobs.update({
            **chunked("rev", "fused_gat", fused_gat._SOURCE, COMBINE_CHUNKS),
            **chunked("fwd", "fused_gat", fused_gat._SOURCE, FWD_CHUNKS, FWD_CHUNK_LINE),
            **chunked("gbwd", "fused_gat", fused_gat._SOURCE, BWD_CHUNKS, BWD_CHUNK_LINE),
            **chunked("rows", "fused_gat", fused_gat._SOURCE, MAX_ROWS, MAX_ROWS_LINE),
            **chunked("fwd", "fused_gat", fused_gat._SOURCE, MIN_BLOCKS, MIN_BLOCKS_LINE)})
    if only != "gat":
        jobs.update({**agg_pairs("sum", "sum_agg", sum_agg._SOURCE),
                     **agg_pairs("max", "max_agg", max_agg._SOURCE)})
    if only is None:
        jobs.update({**chunked("bwd", "max_agg", max_agg._SOURCE, CHUNKS),
                     **chunked("wsum", "weighted_sum", weighted_sum._SOURCE,
                               COMBINE_CHUNKS),
                     ("gather", "this"): ("slot_gather_this", read(slot_gather._SOURCE))})
    # one build of the other checkout's max_agg.cu serves the forward and
    # the backward, one of its fused_gat.cu the three GAT kernels
    stems = {"gat": (("rev", "fused_gat"),),
             "agg": (("sum", "sum_agg"), ("max", "max_agg"))}.get(only, (
        ("sum", "sum_agg"), ("max", "max_agg"), ("gather", "slot_gather"),
        ("wsum", "weighted_sum"), ("rev", "fused_gat")))
    names = [f"against:{d}" if i else "against" for i, d in enumerate(against)]
    for i, (name, other) in enumerate(zip(names, against)):
        for kind, stem in stems:
            jobs[(kind, name)] = (f"{stem}_against{i}",
                                  read(os.path.join(other, CSRC, f"{stem}.cu")))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(build, *job) for key, job in jobs.items()}
        libs = {key: fut.result() for key, fut in futures.items()}
    out = {}
    for (kind, name), lib in libs.items():
        out.setdefault(kind, {})[name] = lib
    if only is None:
        for name in names:
            out["bwd"][name] = libs[("max", name)]
    # the kMaxRows builds time the forward and the backward
    if only != "agg":
        for kind in ("fwd", "gbwd"):
            out[kind].update(out["rows"])
            for name in names:
                out[kind][name] = libs[("rev", name)]
    return out


def tables() -> dict:
    feats, src, dst, _ = cs.flagship_sample(np.random.default_rng(cs.SEED), cs.TRAIN_NODES)
    nbr, mask = ell_from_edges(len(feats), src, dst, n_pad=8192, d_pad=12)
    nbr, mask = np.stack([nbr] * cs.TRAIN_BATCH), np.stack([mask] * cs.TRAIN_BATCH)
    rand = cs.symmetric_tables(np.random.default_rng(cs.SEED + 5), cs.TRAIN_BATCH, 8192,
                               16, n_real=cs.TRAIN_NODES)
    return {"ring D=12": (nbr, mask, reciprocal_slots(nbr, mask)), "random D=16": rand}


def device_kernels(fn) -> list:
    """The device kernels one call of `fn` launches, with their device
    microseconds (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key[:70], round(cs._device_us(e), 2)) for e in cs.device_events(prof)]


def time_agg(libs, tname, nbr, mask, gen) -> None:
    """sum_agg (sum and mean) and max_agg (winner slot stored, and the
    serve variant) at F=20 and 256, f32 and bf16: every build of each, held
    bitwise to the plain version, then timed."""
    dev = nbr.device
    B, N, D = nbr.shape
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for F in (cs.IN_FEATS, cs.TRAIN_WIDTHS[0]):
            h = torch.relu(torch.randn((B, N, F), generator=gen, device=dev)).to(dtype)
            ptrs = (h.data_ptr(), nbr.data_ptr(), mask.data_ptr())
            cases = {}
            for mean in (False, True):
                cases["sum_agg_mean" if mean else "sum_agg"] = (
                    "sum", (sum_agg.sum_aggregate_plain(h, nbr, mask, mean),),
                    lambda lib, o, mean=mean: (
                        lib.gts_sum_agg_f32 if f32 else lib.gts_sum_agg_bf16)(
                        *ptrs, o[0].data_ptr(), B, N, D, F, int(mean),
                        torch.cuda.current_stream().cuda_stream))
            want = max_agg.max_aggregate_plain(h, nbr, mask)
            for store in (True, False):
                cases["max_agg" if store else "max_agg_serve"] = (
                    "max", want if store else want[:1],
                    lambda lib, o, store=store: (
                        lib.gts_max_agg_f32 if f32 else lib.gts_max_agg_bf16)(
                        *ptrs, o[0].data_ptr(), o[1].data_ptr() if store else None,
                        B, N, D, F, int(store), torch.cuda.current_stream().cuda_stream))
            for kname, (kind, want, call) in cases.items():
                times = {}
                for name, lib in libs[kind].items():
                    def run(lib=lib, name=name):
                        o = tuple(torch.empty_like(t) for t in want)
                        if call(lib, o) != 0:
                            raise RuntimeError(f"{kname} {name}: launch failed")
                        return o
                    if not all(torch.equal(cs._bits(a) if a.is_floating_point() else a,
                                           cs._bits(b) if b.is_floating_point() else b)
                               for a, b in zip(run(), want)):
                        raise SystemExit(f"{kname} {name} differs from the plain version "
                                         f"({tname} {dtype} F={F})")
                    times[name] = cs.time_device(run)
                print(f"[{kname}] {tname} {str(dtype)[6:]} F={F}: " + ", ".join(
                    f"{k} {t:.5f} ms" for k, t in times.items()), flush=True)
            del h, cases, want


def time_combines(libs, tname, nbr, mask, rslot, gen) -> None:
    """wsum and wsum_bwd at the main path's (H,F), gat_rev at the hardcoded
    GAT's, f32 and bf16: every build of each, held bitwise to the plain
    version, then timed."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import gat_reverse_combine_plain
    from gnn_tumor_seg_tpu_torch.ops.kernels.weighted_sum import (
        weighted_sum_plain, weighted_sum_reverse_plain)

    dev = nbr.device
    B, N, D = nbr.shape
    gat_shapes = cs.gat_head_shapes(cs.gat_layers())
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for H, F in dict.fromkeys(cs.DECOMPOSED_SHAPES * ("wsum" in libs) + gat_shapes):
            x = torch.randn((B, N, H, F), generator=gen, device=dev).to(dtype)
            w = torch.rand((B, N, D, H), generator=gen, device=dev)
            alpha = torch.rand((B, N, D * H), generator=gen, device=dev)
            d_pre = torch.randn((B, N, D * H), generator=gen, device=dev)
            cases = {}
            if "wsum" in libs and (H, F) in cs.DECOMPOSED_SHAPES:
                for reverse, kname in ((0, "wsum"), (1, "wsum_bwd")):
                    want = (weighted_sum_reverse_plain(x, w, nbr, mask, rslot) if reverse
                            else weighted_sum_plain(x, w, nbr, mask))
                    cases[kname] = ("wsum", want, lambda lib, o, reverse=reverse: (
                        lib.gts_wsum_f32 if f32 else lib.gts_wsum_bf16)(
                        x.data_ptr(), w.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                        rslot.data_ptr(), o[0].data_ptr(), B, N, D, H, F, reverse,
                        torch.cuda.current_stream().cuda_stream))
            if (H, F) in gat_shapes:
                want = gat_reverse_combine_plain(x, alpha, d_pre, nbr, mask, rslot)
                cases["gat_rev"] = ("rev", want, lambda lib, o: (
                    lib.gts_gat_rev_f32 if f32 else lib.gts_gat_rev_bf16)(
                    x.data_ptr(), alpha.data_ptr(), d_pre.data_ptr(), nbr.data_ptr(),
                    mask.data_ptr(), rslot.data_ptr(), o[0].data_ptr(), o[1].data_ptr(),
                    B, N, D, H, F, torch.cuda.current_stream().cuda_stream))
            for kname, (kind, want, call) in cases.items():
                want = want if isinstance(want, tuple) else (want,)
                times = {}
                for name, lib in libs[kind].items():
                    def run(lib=lib, name=name):
                        o = tuple(torch.empty_like(t) for t in want)
                        if call(lib, o) != 0:
                            raise RuntimeError(f"{kname} {name}: launch failed")
                        return o
                    if not all(torch.equal(cs._bits(a), cs._bits(b))
                               for a, b in zip(run(), want)):
                        raise SystemExit(f"{kname} {name} differs from the plain version "
                                         f"({tname} {dtype} H={H} F={F})")
                    times[name] = cs.time_device(run)
                print(f"[{kname}] {tname} {str(dtype)[6:]} H={H} F={F}: " + ", ".join(
                    f"{k} {t:.5f} ms" for k, t in times.items()), flush=True)
            del x, w, alpha, d_pre, cases


def time_gat(libs, tname, nbr, mask) -> None:
    """gat_fwd (training and serve variants) and gat_bwd at the hardcoded
    GAT's (H,F) and layer epilogues, f32 and bf16: every build of each,
    held to the plain version within its tolerance, then timed."""
    from gnn_tumor_seg_tpu_torch.ops.kernels.fused_gat import (
        fused_gat_backward_plain, fused_gat_forward_plain)

    dev = nbr.device
    B, N, D = nbr.shape
    layers = cs.gat_layers()
    rng = np.random.default_rng(cs.SEED + 7)
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        for H, F in cs.gat_head_shapes(layers):
            x = cs.gat_inputs(rng, B, N, H, F, dtype, dev)
            z, gout = x["z"], x["gout"]
            tag = f"{tname} {str(dtype)[6:]} H={H} F={F}"
            for act, with_res in sorted({(a, r) for h, f, a, r in layers
                                         if (h, f) == (H, F)}, key=str):
                res = x["res"] if with_res else None
                want = fused_gat_forward_plain(z, x["el"], x["er"], nbr, mask, 0.2, act,
                                               res, x["bias"])
                for save in (True, False):
                    times = {}
                    for name, lib in libs["fwd"].items():
                        def run(lib=lib, save=save):
                            out = torch.empty_like(z)
                            alpha = pos = None
                            if save:
                                alpha = torch.empty((B, N, D * H), device=dev)
                                pos = torch.empty((B, N, D * H), dtype=torch.uint8,
                                                  device=dev)
                            rc = (lib.gts_gat_fwd_f32 if f32 else lib.gts_gat_fwd_bf16)(
                                z.data_ptr(), x["el"].data_ptr(), x["er"].data_ptr(),
                                nbr.data_ptr(), mask.data_ptr(), x["bias"].data_ptr(),
                                None if res is None else res.data_ptr(), out.data_ptr(),
                                None if alpha is None else alpha.data_ptr(),
                                None if pos is None else pos.data_ptr(), B, N, D, H, F,
                                0.2, int(act == "elu"), int(save),
                                torch.cuda.current_stream().cuda_stream)
                            if rc != 0:
                                raise RuntimeError(f"gat_fwd {name}: launch failed ({rc})")
                            return out, alpha, pos
                        out, alpha, pos = run()
                        err = cs.within(out, want[0], not f32)
                        if save:
                            err = max(err, cs.within(alpha, want[1]))
                            if not torch.equal(pos, want[2]):
                                raise SystemExit(f"gat_fwd {name}: sign mask differs ({tag})")
                        if err > cs.GAT_FWD_TOL:
                            raise SystemExit(f"gat_fwd {name} differs from the plain "
                                             f"version ({tag} act={act}): {err:.3g}")
                        times[name] = cs.time_device(run)
                    print(f"[gat_fwd{'' if save else '_serve'}] {tag} act={act} "
                          f"res={with_res}: " + ", ".join(
                              f"{k} {t:.5f} ms" for k, t in times.items()), flush=True)
            alpha, pos = want[1], want[2]
            w_pre, w_er = fused_gat_backward_plain(gout, z, alpha, pos, nbr, mask)
            times = {}
            for name, lib in libs["gbwd"].items():
                def run(lib=lib):
                    d_pre = torch.empty((B, N, D * H), device=dev)
                    d_er = torch.empty((B, N, H), device=dev)
                    rc = (lib.gts_gat_bwd_f32 if f32 else lib.gts_gat_bwd_bf16)(
                        gout.data_ptr(), z.data_ptr(), alpha.data_ptr(), pos.data_ptr(),
                        nbr.data_ptr(), mask.data_ptr(), d_pre.data_ptr(), d_er.data_ptr(),
                        B, N, D, H, F, 0.2, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"gat_bwd {name}: launch failed ({rc})")
                    return d_pre, d_er
                d_pre, d_er = run()
                err = max(cs.within(d_pre, w_pre), cs.within(d_er, w_er))
                if err > cs.GAT_BWD_TOL:
                    raise SystemExit(f"gat_bwd {name} differs from the plain version "
                                     f"({tag}): {err:.3g}")
                times[name] = cs.time_device(run)
            print(f"[gat_bwd] {tag}: " + ", ".join(
                f"{k} {t:.5f} ms" for k, t in times.items()), flush=True)
            del x, z, gout, want, alpha, pos


def launcher(fn, args, name):
    def run(out):
        rc = fn(*args(out), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed ({rc})")
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", action="append", default=[],
                        help="a checkout whose kernel sources to time too (repeatable)")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--gat", action="store_const", dest="only", const="gat",
                      help="time the three fused GAT kernels alone")
    only.add_argument("--agg", action="store_const", dest="only", const="agg",
                      help="time sum_agg and max_agg alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    libs = build_all(args.against, args.only)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for tname, arrays in tables().items():
        nbr, mask, rslot = (torch.from_numpy(a).to(dev) for a in arrays)
        if args.only != "gat":
            time_agg(libs, tname, nbr, mask, gen)
        if args.only == "agg":
            continue
        time_gat(libs, tname, nbr, mask)
        time_combines(libs, tname, nbr, mask, rslot, gen)
        if args.only == "gat":
            continue
        bwd, gather = libs["bwd"], libs["gather"]
        B, N, D = nbr.shape
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            for F in (cs.IN_FEATS, cs.TRAIN_WIDTHS[0]):
                h = torch.relu(torch.randn((B, N, F), generator=gen, device=dev)).to(dtype)
                gout = torch.randn((B, N, F), generator=gen, device=dev).to(dtype)
                _, arg = max_agg.max_aggregate(h, nbr, mask, with_arg=True)
                want = max_agg.max_aggregate_backward_plain(gout, arg, nbr, mask, rslot)
                times = {}
                for name, lib in bwd.items():
                    run = launcher(
                        lib.gts_max_agg_bwd_f32 if f32 else lib.gts_max_agg_bwd_bf16,
                        lambda g: (gout.data_ptr(), arg.data_ptr(), nbr.data_ptr(),
                                   mask.data_ptr(), rslot.data_ptr(), g.data_ptr(),
                                   B, N, D, F), name)
                    if not torch.equal(cs._bits(run(torch.empty_like(gout))), cs._bits(want)):
                        raise SystemExit(f"max_agg_bwd {name} differs from the plain version")
                    times[name] = cs.time_device(lambda: run(torch.empty_like(gout)))
                print(f"[max_agg_bwd] {tname} {str(dtype)[6:]} F={F}: " + ", ".join(
                    f"{k} {t:.5f} ms" for k, t in times.items()), flush=True)
        if not tname.startswith("ring"):
            continue
        offs = (torch.arange(B, device=dev) * N).view(B, 1, 1)
        ridx = torch.where(mask > 0, nbr + offs, B * N).reshape(-1)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            for W in cs.SLOT_WIDTHS:
                x = torch.randn((B, N, W), generator=gen, device=dev).to(dtype)
                want = slot_gather.slot_gather_plain(x, nbr, mask)
                times = {}
                for name, lib in gather.items():
                    run = launcher(
                        lib.gts_slot_gather_f32 if f32 else lib.gts_slot_gather_bf16,
                        lambda o: (x.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                                   o.data_ptr(), B, N, D, W), name)
                    if not torch.equal(cs._bits(run(torch.empty_like(want))), cs._bits(want)):
                        raise SystemExit(f"slot_gather {name} differs from the plain version")
                    times[name] = cs.time_device(lambda: run(torch.empty_like(want)))
                wt = torch.cat([x.reshape(B * N, W), x.new_zeros(1, W)])
                embedding = lambda: F_.embedding(ridx, wt, padding_idx=B * N)
                times["F.embedding"] = cs.time_device(embedding)
                print(f"[slot_gather] {tname} {str(dtype)[6:]} W={W}: " + ", ".join(
                    f"{k} {t:.5f} ms" for k, t in times.items())
                    + f"; F.embedding launches {device_kernels(embedding)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
