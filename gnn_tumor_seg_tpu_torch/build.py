"""Build the port's shared libraries at first use.

The host C++ kernels (native/gts_native.cc, with g++) and the CUDA kernels
(ops/kernels/csrc/*.cu, with nvcc for sm_90a) compile into BUILD_DIR, which
git ignores. A library's file name carries a hash of its sources and its
command line, so an edited source is rebuilt and a stale library is never
loaded. The compiler writes to a temporary name that is renamed into place,
so processes that build the same library at once never load a partial file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

__all__ = ["BUILD_DIR", "build_library"]

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_library(stem: str, sources: list[str],
                  command: list[str]) -> tuple[str, str]:
    """Compile `sources` with `command` (compiler and flags, without the
    output and source arguments) into BUILD_DIR/<stem>-<hash>.so.

    Returns (library path, compiler output); the output is empty when the
    library was already built. Raises RuntimeError when the compiler fails."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{stem}-", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {stem} failed ({' '.join(command)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr
