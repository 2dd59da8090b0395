"""CLI: warm the serve path of a cold process (counterpart of
gnn_tumor_seg_tpu/cli/warmup.py).

The single-MRI contract runs one prediction per container invocation, a
cold process. The port's cold cost is building its libraries (nvcc for the
five CUDA kernel sources, g++ for the native host library; 5-11 s a file)
into gnn_tumor_seg_tpu_torch/_build/, which later processes load without
building. Run once at image build or host deploy, this builds them all in
parallel and then drives one real `predict_single_mri` request on a
synthetic BraTS-shaped brain with the serve flags, reporting the build and
request times.

The JAX warmup's `_prime_upload_buckets` is not ported: it compiles the XLA
programs of the flat-upload voxel buckets, and the port has neither XLA
compiles nor buckets (ops/slic_device.py).

Run:  python -m gnn_tumor_seg_tpu_torch.cli.warmup -g gnn.ckpt -c cnn.ckpt \\
          [--slic_impl tpu] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

#: shape of the synthetic brain (the BraTS raw extent)
WARMUP_SHAPE = (240, 240, 155)


def make_synthetic_brain(shape=WARMUP_SHAPE, seed=0):
    """Four smooth modality volumes with a bright blob, BraTS-shaped: enough
    structure for the brain crop, SLIC and tumor crop to behave like a real
    sample (values never leave this process)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    base = ndimage.gaussian_filter(
        rng.normal(size=shape).astype(np.float32), 6.0)
    mods = []
    x, y, z = np.meshgrid(*(np.arange(s, dtype=np.float32) for s in shape),
                          indexing="ij")
    blob = np.exp(-(((x - shape[0] / 2) ** 2 + (y - shape[1] / 2) ** 2
                     + (z - shape[2] / 2) ** 2) / (2 * 18.0 ** 2)))
    for m in range(4):
        v = base * 40.0 + 100.0 + blob * (80.0 + 20.0 * m)
        v[:30] = 0.0
        v[-30:] = 0.0  # background margin so the brain crop is non-trivial
        mods.append(v.astype(np.float32))
    return mods


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-g", "--gnn_weights", required=True, type=str)
    p.add_argument("-c", "--cnn_weights", required=True, type=str)
    p.add_argument("-n", "--num_nodes", default=15000, type=int)
    p.add_argument("--precision", default="fast", choices=("exact", "fast"))
    p.add_argument("--slic_impl", default="auto",
                   choices=("auto", "native", "numpy", "tpu"))
    p.add_argument("--cnn_prep", default="device", choices=("device", "host"))
    p.add_argument("--prep_impl", default="auto",
                   choices=("auto", "host", "device"),
                   help="'device' warms the device preprocessing path; "
                        "'auto' = device when --slic_impl tpu")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cpu' builds only the native library and runs "
                        "every kernel's plain PyTorch version")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..build import build_all
    from ..data import nifti
    from ..ops.precision import set_precision_mode
    from ..runtime import resolve_device
    from .common import (load_cnn_from_checkpoint, load_gnn_from_checkpoint,
                         resolve_slic_fn)
    from .predict_single import predict_single_mri

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    built = build_all(cuda=dev.type == "cuda")
    build_s = time.perf_counter() - t0
    for name, (_, secs) in built.items():
        print(f"Built {name} in {secs:.2f} s")
    set_precision_mode(args.precision)
    _, _, gnn_fwd = load_gnn_from_checkpoint(
        os.path.expanduser(args.gnn_weights), device=dev)
    _, _, cnn_fwd = load_cnn_from_checkpoint(
        os.path.expanduser(args.cnn_weights), device=dev)
    prep_impl = args.prep_impl
    if prep_impl == "auto":
        prep_impl = "device" if args.slic_impl == "tpu" else "host"
    with tempfile.TemporaryDirectory(prefix="gts_warmup_") as tmp:
        for name, vol in zip(("flair", "t1", "t1ce", "t2"),
                             make_synthetic_brain(WARMUP_SHAPE)):
            nifti.save_as_nifti(vol, os.path.join(tmp, f"w_{name}.nii.gz"))
        t0 = time.perf_counter()
        pred = predict_single_mri(
            tmp, gnn_fwd, cnn_fwd, num_nodes=args.num_nodes,
            slic_fn=resolve_slic_fn(args.slic_impl, device=dev),
            cnn_prep=args.cnn_prep, prep_impl=prep_impl, device=dev)
        request_s = time.perf_counter() - t0
    print(f"Warmup built {len(built)} libraries in {build_s:.2f} s and ran "
          f"one request ({prep_impl} preprocessing) in {request_s:.2f} s "
          f"(shape {pred.shape}) on {dev}")


if __name__ == "__main__":
    main()
