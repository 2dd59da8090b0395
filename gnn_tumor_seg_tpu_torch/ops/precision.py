"""Precision modes of the port (counterpart of gnn_tumor_seg_tpu/ops/pallas/precision.py).

  "exact" — float32 everywhere, with TF32 switched off for both matrix
            products and cuDNN convolutions. PyTorch leaves cuDNN's TF32 on
            by default, which would silently change the refinement CNN's
            numbers. Entering the mode switches both flags off.
  "fast"  — bf16 activations, float32 master parameters cast at use, float32
            logits at each model's head (models/sage.py, models/refine_cnn.py).
            The TF32 flags are left as they are.

The default is "exact", applied at import. set_precision_mode sets the
process-wide mode and its flags; precision_scope overrides both for a block
and restores both afterwards. Neither is thread-safe: the mode is a process
global, set on one thread. Training runs in "fast" unless the trainer is
given a mode or GTS_PALLAS_PRECISION names one, as for the JAX package
(training_precision).
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["get_precision_mode", "set_precision_mode", "precision_scope",
           "fast_precision", "compute_dtype", "training_precision"]

_MODES = ("exact", "fast")
_MODE = "exact"


def _validate(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"precision mode must be one of {_MODES}, got {mode!r}")


def _tf32_flags() -> tuple[bool, bool]:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32_flags(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _enter(mode: str) -> None:
    global _MODE
    _MODE = mode
    if mode == "exact":
        _set_tf32_flags(False, False)


def set_precision_mode(mode: str) -> None:
    _validate(mode)
    _enter(mode)


def get_precision_mode() -> str:
    return _MODE


@contextlib.contextmanager
def precision_scope(mode: str):
    """Scoped mode override (restores the previous mode and TF32 flags on
    exit)."""
    global _MODE
    _validate(mode)
    prev, flags = _MODE, _tf32_flags()
    _enter(mode)
    try:
        yield
    finally:
        _MODE = prev
        _set_tf32_flags(*flags)


def training_precision(mode: str | None = None) -> str:
    """A trainer's mode: `mode`, or GTS_PALLAS_PRECISION's when None
    ("fast" when unset); ValueError for any other than the two modes."""
    if mode is None:
        mode = os.environ.get("GTS_PALLAS_PRECISION", "fast")
    _validate(mode)
    return mode


def fast_precision() -> bool:
    return get_precision_mode() == "fast"


def compute_dtype() -> torch.dtype:
    """Activation dtype: bfloat16 under "fast", float32 under "exact"."""
    return torch.bfloat16 if fast_precision() else torch.float32


_enter(_MODE)
