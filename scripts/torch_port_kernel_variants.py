#!/usr/bin/env python3
"""Time variants of the PyTorch port's max_agg_bwd and slot_gather kernels on
one NVIDIA H100.

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
kernel that F.embedding launches there.

--against DIR builds DIR's copies of both sources (for example a `git
archive` of another commit; their C interfaces must be this checkout's) and
times them beside these. Sources are built with nvcc for sm_90a into the
port's _build/ directory; times are device ms per call by CUDA-graph replay
(chip_smoke.time_device). Prints the card, ptxas' registers per kernel, and
one line of times per shape.
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
from gnn_tumor_seg_tpu_torch.ops.kernels import max_agg, slot_gather  # noqa: E402

# kChunk values: constants, and per vector width (VEC = 8 at F=256, 4 at F=20)
CHUNKS = ("1", "2", "4", "8", "VEC == 8 ? 1 : 4", "VEC == 8 ? 2 : 4")
CHUNK_LINE = re.compile(r"constexpr int kChunk = [^;]+;")
CSRC = os.path.join("gnn_tumor_seg_tpu_torch", "ops", "kernels", "csrc")
VP, I32 = ctypes.c_void_p, ctypes.c_int


def build(stem: str, source: str) -> ctypes.CDLL:
    path = os.path.join(BUILD_DIR, stem + ".cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(source)
    lib, log = build_cuda_library(stem, path)
    regs = re.findall(r"Used (\d+) registers", log)
    print(f"[build] {stem}: registers per kernel {regs}", flush=True)
    if hasattr(lib, "gts_max_agg_bwd_f32"):
        for fn in (lib.gts_max_agg_bwd_f32, lib.gts_max_agg_bwd_bf16):
            fn.argtypes = [VP] * 6 + [I32] * 4 + [VP]
            fn.restype = I32
    else:
        for fn in (lib.gts_slot_gather_f32, lib.gts_slot_gather_bf16):
            fn.argtypes = [VP] * 4 + [I32] * 4 + [VP]
            fn.restype = I32
    return lib


def build_all(against: str | None):
    """Every variant, one nvcc each, all started together."""
    def read(path):
        with open(path) as f:
            return f.read()

    source = read(max_agg._SOURCE)
    if len(CHUNK_LINE.findall(source)) != 1:
        raise SystemExit(f"expected one kChunk line in {max_agg._SOURCE}")
    jobs = {("bwd", f"kChunk={c}"): (f"max_agg_chunk{i}",
                                     CHUNK_LINE.sub(f"constexpr int kChunk = {c};", source))
            for i, c in enumerate(CHUNKS)}
    jobs[("gather", "this")] = ("slot_gather_this", read(slot_gather._SOURCE))
    if against:
        jobs[("bwd", "against")] = ("max_agg_against",
                                    read(os.path.join(against, CSRC, "max_agg.cu")))
        jobs[("gather", "against")] = ("slot_gather_against",
                                       read(os.path.join(against, CSRC, "slot_gather.cu")))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(build, *job) for key, job in jobs.items()}
        libs = {key: fut.result() for key, fut in futures.items()}
    return ({name: lib for (kind, name), lib in libs.items() if kind == "bwd"},
            {name: lib for (kind, name), lib in libs.items() if kind == "gather"})


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
    bwd, gather = build_all(args.against)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for tname, arrays in tables().items():
        nbr, mask, rslot = (torch.from_numpy(a).to(dev) for a in arrays)
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
