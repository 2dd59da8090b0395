#!/usr/bin/env python3
"""Time variants of the PyTorch port's max_agg_bwd, slot_gather, wsum,
wsum_bwd and gat_rev kernels on one NVIDIA H100.

Run from the repository root on a machine with the card:

    python3 scripts/torch_port_kernel_variants.py [--against DIR]

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
symmetric; each held bitwise to its plain PyTorch version.

--against DIR builds DIR's copies of the four sources (for example a `git
archive` of another commit; their C interfaces must be this checkout's) and
times them beside these. Sources are built with nvcc for sm_90a into the
port's _build/ directory; times are device ms per call by CUDA-graph replay
(chip_smoke.time_device). Prints the card, ptxas' registers and spills per
kernel, and one line of times per shape.
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
    fused_gat, max_agg, slot_gather, weighted_sum)

# max_agg_bwd's kChunk values: constants, and per vector width (VEC = 8 at
# F=256, 4 at F=20)
CHUNKS = ("1", "2", "4", "8", "VEC == 8 ? 1 : 4", "VEC == 8 ? 2 : 4")
# the weighted combines' kChunk values (gat_rev ships the last, wsum the first)
COMBINE_CHUNKS = ("2", "4", "8", "VEC == 8 ? 4 : 2")
CHUNK_LINE = re.compile(r"constexpr int kChunk = [^;]+;")
CSRC = os.path.join("gnn_tumor_seg_tpu_torch", "ops", "kernels", "csrc")
VP, I32 = ctypes.c_void_p, ctypes.c_int


def build(stem: str, source: str) -> ctypes.CDLL:
    path = os.path.join(BUILD_DIR, stem + ".cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(source)
    lib, log = build_cuda_library(stem, path)
    for kern, regs, stores, loads in cs.ptxas_kernels(log):
        if any(k in kern for k in ("max_agg_bwd", "slot_gather", "wsum", "gat_rev")):
            print(f"[build] {stem}: {kern}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B", flush=True)
    if hasattr(lib, "gts_max_agg_bwd_f32"):
        fns, args = (lib.gts_max_agg_bwd_f32, lib.gts_max_agg_bwd_bf16), [VP] * 6 + [I32] * 4
    elif hasattr(lib, "gts_wsum_f32"):
        fns, args = (lib.gts_wsum_f32, lib.gts_wsum_bf16), [VP] * 6 + [I32] * 6
    elif hasattr(lib, "gts_gat_rev_f32"):
        fns, args = (lib.gts_gat_rev_f32, lib.gts_gat_rev_bf16), [VP] * 8 + [I32] * 5
    else:
        fns, args = (lib.gts_slot_gather_f32, lib.gts_slot_gather_bf16), [VP] * 4 + [I32] * 4
    for fn in fns:
        fn.argtypes = args + [VP]
        fn.restype = I32
    return lib


def build_all(against: str | None) -> dict:
    """Every variant, one nvcc each, all started together: {kind: {name:
    library}} for the kinds "bwd" (max_agg.cu), "gather" (slot_gather.cu),
    "wsum" (weighted_sum.cu) and "rev" (fused_gat.cu)."""
    def read(path):
        with open(path) as f:
            return f.read()

    def chunked(kind, stem, path, chunks):
        source = read(path)
        if len(CHUNK_LINE.findall(source)) != 1:
            raise SystemExit(f"expected one kChunk line in {path}")
        return {(kind, f"kChunk={c}"): (f"{stem}_chunk{i}", CHUNK_LINE.sub(
            f"constexpr int kChunk = {c};", source)) for i, c in enumerate(chunks)}

    jobs = {**chunked("bwd", "max_agg", max_agg._SOURCE, CHUNKS),
            **chunked("wsum", "weighted_sum", weighted_sum._SOURCE, COMBINE_CHUNKS),
            **chunked("rev", "fused_gat", fused_gat._SOURCE, COMBINE_CHUNKS),
            ("gather", "this"): ("slot_gather_this", read(slot_gather._SOURCE))}
    if against:
        for kind, stem in (("bwd", "max_agg"), ("gather", "slot_gather"),
                           ("wsum", "weighted_sum"), ("rev", "fused_gat")):
            jobs[(kind, "against")] = (f"{stem}_against",
                                       read(os.path.join(against, CSRC, f"{stem}.cu")))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(build, *job) for key, job in jobs.items()}
        libs = {key: fut.result() for key, fut in futures.items()}
    out = {}
    for (kind, name), lib in libs.items():
        out.setdefault(kind, {})[name] = lib
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
        for H, F in dict.fromkeys(cs.DECOMPOSED_SHAPES + gat_shapes):
            x = torch.randn((B, N, H, F), generator=gen, device=dev).to(dtype)
            w = torch.rand((B, N, D, H), generator=gen, device=dev)
            alpha = torch.rand((B, N, D * H), generator=gen, device=dev)
            d_pre = torch.randn((B, N, D * H), generator=gen, device=dev)
            cases = {}
            if (H, F) in cs.DECOMPOSED_SHAPES:
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


def launcher(fn, args, name):
    def run(out):
        rc = fn(*args(out), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed ({rc})")
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="a checkout whose kernel sources to time too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    libs = build_all(args.against)
    bwd, gather = libs["bwd"], libs["gather"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for tname, arrays in tables().items():
        nbr, mask, rslot = (torch.from_numpy(a).to(dev) for a in arrays)
        time_combines(libs, tname, nbr, mask, rslot, gen)
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
