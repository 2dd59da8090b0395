"""Minimal NIfTI-1 reader/writer in pure numpy (nibabel replacement).

Capability match for `data_processing/nifti_io.py`: read modality stacks from a
scan directory, read label volumes, write volumes with the fixed BraTS affine
(`nifti_io.py:42-50`). Implemented against the NIfTI-1 specification (348-byte
header, single-file .nii / .nii.gz, x-fastest data order); supports the dtypes
BraTS uses (uint8/int16/int32/float32/float64) plus scl_slope/scl_inter scaling
on read.

A copy of gnn_tumor_seg_tpu/data/nifti.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import os
import struct
import zlib

import numpy as np

__all__ = [
    "read_nifti", "write_nifti", "save_as_nifti",
    "read_in_patient_sample", "read_in_labels",
    "BRATS_AFFINE",
]

# The BraTS/TCIA standard affine used by the reference writer (`nifti_io.py:43-48`).
BRATS_AFFINE = np.array([
    [-1.0, -0.0, -0.0, -0.0],
    [-0.0, -1.0, -0.0, 239.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_HDR_SIZE = 348


def _open(fp: str, mode: str):
    if fp.endswith(".gz"):
        # level 1: ~6x faster writes than Python's default 9 at ~15% larger
        # files — the right trade for pipeline artifacts (matches nibabel)
        return gzip.open(fp, mode, compresslevel=1) if "w" in mode \
            else gzip.open(fp, mode)
    return open(fp, mode)


def _gunzip_all(buf: bytes) -> bytes:
    """One-shot decompress of a (possibly multi-member) gzip stream.

    Multi-member files are what _gzip_parallel writes; plain single-member
    files (any external tool) take exactly one loop iteration, preserving the
    measured one-shot-zlib speed advantage over gzip.open's chunked streams."""
    out = []
    while buf:
        o = zlib.decompressobj(wbits=31)
        out.append(o.decompress(buf))
        out.append(o.flush())
        buf = o.unused_data
    return out[0] if len(out) == 1 else b"".join(out)


def _read_bytes(fp: str) -> bytes:
    if fp.endswith(".gz"):
        # one-shot zlib decompress of the whole file: measurably faster than
        # gzip.open's chunked streaming (the dominant preprocess cost per brain)
        with open(fp, "rb") as f:
            return _gunzip_all(f.read())
    with open(fp, "rb") as f:
        return f.read()


def _gzip_parallel(parts: list, level: int = 1,
                   chunk: int = 8 << 20) -> bytes:
    """Compress a byte payload as CONCATENATED gzip members, one per ~8 MB
    chunk, compressed in parallel threads (zlib releases the GIL). RFC 1952
    defines a gzip file as a sequence of members, so every gzip reader
    (gzip.open, nibabel, zcat) accepts the output; _gunzip_all reads it
    one-shot. Halves the per-brain write cost on the 2-core preprocess host.

    parts may mix bytes-like items and CALLABLES returning bytes-like: a
    callable is invoked inside its worker, so producing a part (e.g. the
    F-order transpose of an array slab) runs in parallel with compressing the
    others — and nothing is ever joined into one monolithic payload."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []           # each job: list of bytes-like / callables, one member
    cur, cur_len = [], 0
    for p in parts:
        if callable(p):
            if cur:
                jobs.append(cur)
                cur, cur_len = [], 0
            jobs.append([p])
            continue
        v = memoryview(p).cast("B")
        for i in range(0, len(v), chunk):
            piece = v[i:i + chunk]
            cur.append(piece)
            cur_len += len(piece)
            if cur_len >= chunk:
                jobs.append(cur)
                cur, cur_len = [], 0
    if cur or not jobs:
        jobs.append(cur or [b""])

    def member(pieces):
        c = zlib.compressobj(level, zlib.DEFLATED, 31)
        out = []
        for p in pieces:
            if callable(p):
                p = p()
            out.append(c.compress(p))
        out.append(c.flush())
        return b"".join(out)

    if len(jobs) == 1:
        return member(jobs[0])
    with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as pool:
        return b"".join(pool.map(member, jobs))


def _forder_parts(img: np.ndarray) -> list:
    """The array's F-order byte stream: a zero-copy view for F-contiguous
    inputs (read_nifti returns F-backed volumes, so read-modify-write flows
    skip the transpose entirely), one numpy-optimized transpose otherwise.
    (Per-last-axis slab thunks transposed inside the compression workers were
    tried and REVERTED: single-channel strided reads of channel-interleaved
    data waste ~4x memory bandwidth and measured 0.3-0.5 s/brain SLOWER in
    the saturated preprocess pool than numpy's blocked full transpose.)"""
    if img.flags.f_contiguous:
        return [memoryview(img.T).cast("B")]      # zero-copy: .T is C-contig
    return [img.tobytes(order="F")]


def read_nifti(fp: str, dtype=None, return_affine: bool = False):
    """Read a .nii / .nii.gz volume -> numpy array (optionally with its affine)."""
    raw = _read_bytes(fp)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{fp}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != _HDR_SIZE:
        if struct.unpack_from(">i", raw, 0)[0] == _HDR_SIZE:
            raise ValueError(f"{fp}: big-endian NIfTI not supported")
        raise ValueError(f"{fp}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{fp}: bad NIfTI magic {magic!r}")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{fp}: bad ndim {ndim}")
    shape = tuple(dim[1:1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{fp}: unsupported datatype code {datatype}")
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0]) or _HDR_SIZE + 4
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    arr_dtype = _DTYPES[datatype]
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=arr_dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    if dtype is not None:
        data = np.asarray(data, dtype=dtype)
    else:
        data = np.asarray(data)
    if return_affine:
        srow = np.frombuffer(raw[280:328], dtype="<f4").reshape(3, 4)
        affine = np.vstack([srow, [0, 0, 0, 1]]).astype(np.float64)
        return data, affine
    return data


def write_nifti(img: np.ndarray, fp: str, affine: np.ndarray = BRATS_AFFINE) -> None:
    """Write a 3D/4D numpy array as single-file NIfTI-1 (.nii or .nii.gz)."""
    img = np.asarray(img)
    if img.dtype == np.int64:
        img = img.astype(np.int32)
    if img.dtype == np.bool_:
        img = img.astype(np.uint8)
    if img.dtype not in _CODES:
        img = img.astype(np.float32)
    code = _CODES[img.dtype]
    bitpix = img.dtype.itemsize * 8
    ndim = img.ndim
    dim = [ndim] + list(img.shape) + [1] * (7 - ndim)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    # pixdim: qfac then unit spacings
    struct.pack_into("<8f", hdr, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, float(_HDR_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)             # scl_slope/inter
    struct.pack_into("<b", hdr, 123, 10)                    # xyzt_units: mm | sec
    struct.pack_into("<2h", hdr, 252, 0, 1)                 # qform_code=0, sform_code=1
    affine = np.asarray(affine, dtype=np.float32)
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    d = os.path.dirname(os.path.abspath(fp))
    if d:
        os.makedirs(d, exist_ok=True)
    parts = [bytes(hdr), b"\x00\x00\x00\x00", *_forder_parts(img)]
    if fp.endswith(".gz"):
        # parallel multi-member gzip with per-slab F-order transposes fused
        # into the compression workers (no monolithic tobytes/join copies)
        blob = _gzip_parallel(parts)
        with open(fp, "wb") as f:
            f.write(blob)
    else:
        with open(fp, "wb") as f:
            for p in parts:
                f.write(p() if callable(p) else p)


def save_as_nifti(img: np.ndarray, fp: str) -> None:
    """Reference-contract writer with the hardcoded BraTS affine (`nifti_io.py:42-50`)."""
    write_nifti(img, fp, BRATS_AFFINE)


def read_in_patient_sample(scan_dir: str, modality_exts: list[str]) -> np.ndarray:
    """Walk scan_dir for files ending in each modality extension and stack them
    channels-last (`nifti_io.py:12-28`). Asserts all modalities are present.

    Modalities decode in parallel threads: zlib releases the GIL, so the four
    per-brain gzip decodes (the preprocess hotspot) overlap."""
    by_ext = {ext: [] for ext in modality_exts}
    for root, _, files in os.walk(scan_dir):
        for ext in modality_exts:
            for filename in files:
                if filename.endswith(ext):
                    by_ext[ext].append(os.path.join(root, filename))
    missing = [ext for ext, hits in by_ext.items() if not hits]
    if missing:
        raise FileNotFoundError(
            f"missing modality file(s) {missing} in {scan_dir} "
            f"(found: {sorted(os.path.basename(p) for hits in by_ext.values() for p in hits)})")
    dupes = {ext: [os.path.basename(p) for p in hits]
             for ext, hits in by_ext.items() if len(hits) > 1}
    if dupes:
        raise ValueError(
            f"ambiguous modality file(s) in {scan_dir}: {dupes} — exactly one "
            f"file per modality extension is required")
    paths = [by_ext[ext][0] for ext in modality_exts]

    def read_with_context(p):
        # raise-with-context on unreadable artifacts, the reference's serve
        # behavior (`generate_joint_predictions.py:47-51`)
        try:
            return read_nifti(p, np.float32)
        except Exception as exc:
            raise RuntimeError(f"failed to read modality volume {p}: "
                               f"{exc}") from exc

    if len(paths) == 1:
        return read_with_context(paths[0])
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as ex:
        modality_imgs = list(ex.map(read_with_context, paths))
    shapes = {img.shape for img in modality_imgs}
    if len(shapes) > 1:
        raise ValueError(
            f"modality volumes in {scan_dir} have mismatched shapes {shapes} "
            f"— all modalities must be co-registered to one grid")
    return np.stack(modality_imgs, 3)


def read_in_labels(scan_dir: str, label_ext: str) -> np.ndarray:
    """Find and read the label volume in a scan directory (`nifti_io.py:31-37`)."""
    for filename in sorted(os.listdir(scan_dir)):
        if filename.endswith(label_ext):
            return read_nifti(os.path.join(scan_dir, filename), np.int16)
    raise FileNotFoundError(f"Label image not found in folder: {scan_dir}")
