"""CUDA launch wrapper of the fused error-feedback + block top-k kernel.

Replaces the Pallas kernel ``repro/kernels/topk_ef/topk_ef.py::
_topk_ef_kernel``; the kernel itself is ``csrc/topk_ef.cu`` (its notes
give the bound and the design). Per row of a ``(rows, bc)`` view:
``g = lr*grad + err``, the kb largest ``|g|`` by masked argmax with the
lowest-index tie-break, ``new_err = where(taken, 0, g)``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build

MAX_BLOCK = 2048
LAUNCHES = build.LaunchCounter()

_SIGNATURES = {
    "repro_topk_ef": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "repro_block_topk": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def library() -> ctypes.CDLL:
    """The built kernel library (compiled by nvcc at first use)."""
    return build.load("topk_ef", _SIGNATURES)


def check_rows(name: str, x: torch.Tensor, kb: int) -> None:
    """Validate a (rows, bc) float32 CUDA operand for the row kernels."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D (rows, bc) view, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    bc = x.shape[1]
    if not 1 <= bc <= MAX_BLOCK:
        raise ValueError(f"{name}: block width {bc} outside [1, {MAX_BLOCK}]")
    if not 1 <= kb <= bc:
        raise ValueError(f"{name}: kb={kb} outside [1, {bc}]")


def topk_ef_cuda(grad2d: torch.Tensor, err2d: torch.Tensor, lr: float, kb: int):
    """Launch the kernel. Returns ``(new_err, values, local_indices)``:
    ``(rows, bc)`` f32, ``(rows, kb)`` f32, ``(rows, kb)`` int32."""
    check_rows("topk_ef", grad2d, kb)
    check_rows("topk_ef", err2d, kb)
    if err2d.shape != grad2d.shape or err2d.device != grad2d.device:
        raise ValueError("topk_ef: grad and err differ in shape or device")
    rows, bc = grad2d.shape
    new_err = torch.empty_like(grad2d)
    vals = torch.empty((rows, kb), dtype=torch.float32, device=grad2d.device)
    idx = torch.empty((rows, kb), dtype=torch.int32, device=grad2d.device)
    if rows == 0:
        return new_err, vals, idx
    with torch.cuda.device(grad2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().repro_topk_ef(
            grad2d.data_ptr(), err2d.data_ptr(), float(lr), new_err.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), rows, bc, kb, stream,
        )
    build.check(rc, "topk_ef")
    LAUNCHES.count += 1
    return new_err, vals, idx
