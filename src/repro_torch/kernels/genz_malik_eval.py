"""Launch wrapper of the fused Genz-Malik CUDA kernel (csrc/genz_malik_eval.cu).

Replaces the Pallas TPU kernel ``genz_malik_eval_soa`` of
``src/repro/kernels/genz_malik_eval.py``.  The wrapper checks its inputs,
chooses the threads per block (:func:`resolve_block`), allocates the
outputs, and launches on the current CUDA stream without synchronising.  It counts its launches
(:func:`launch_count`), so that a run can show that the main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.genz_malik import (
    FOURTH_DIFF_RATIO,
    LAMBDA2,
    LAMBDA3,
    LAMBDA4,
    LAMBDA5,
    gm_weights,
)
from repro_torch.kernels import build

MAX_D = 16  # GM_MAX_D of gm_launch.h
MAX_BLOCK = 512  # kMaxBlock, the kernel's __launch_bounds__
DEFAULT_BLOCK = 256

# Theta rows each kernel id reads, in units of d (families of integrands.py).
THETA_ROWS_PER_AXIS = {7: 2, 8: 2, 9: 1}

_SYMBOLS = {torch.float64: "gm_eval_f64", torch.float32: "gm_eval_f32"}
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("genz_malik_eval"), _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # device
        ctypes.c_int,  # kernel_id
        ctypes.c_int,  # d
        ctypes.c_longlong,  # B
        ctypes.c_int,  # threads per block
        ctypes.c_void_p,  # centers
        ctypes.c_void_p,  # halfw
        ctypes.c_void_p,  # theta (may be NULL)
        ctypes.c_longlong,  # theta row stride
        ctypes.c_longlong,  # theta lane stride
        ctypes.c_void_p,  # i7
        ctypes.c_void_p,  # i5
        ctypes.c_void_p,  # i3
        ctypes.c_void_p,  # diffs
        ctypes.c_void_p,  # host array of 16 rule constants
        ctypes.c_void_p,  # stream
    ]
    return fn


def _consts(d: int):
    w = gm_weights(d)
    vals = (
        LAMBDA2, LAMBDA3, LAMBDA4, LAMBDA5, FOURTH_DIFF_RATIO,
        w.w1, w.w2, w.w3, w.w4, w.w5, w.e1, w.e2, w.e3, w.e4, w.t1, w.t3,
    )
    return (ctypes.c_double * len(vals))(*vals)


def resolve_block(block_regions: int) -> int:
    block = block_regions or DEFAULT_BLOCK
    if block < 1 or block & (block - 1) or block > MAX_BLOCK:
        raise ValueError(
            f"block_regions must be a power of two <= {MAX_BLOCK} (or 0 = "
            f"{DEFAULT_BLOCK}), got {block_regions}"
        )
    return block


def genz_malik_eval_soa(
    kernel_id: int,
    centers: torch.Tensor,  # (d, B) SoA, contiguous, on a CUDA device
    halfw: torch.Tensor,  # (d, B)
    theta_rows: Optional[torch.Tensor] = None,  # (n_theta, B), any strides
    block_regions: int = 0,
):
    """Launch the fused GM kernel.  Returns (i7, i5, i3, diffs (d, B)).

    ``theta_rows`` may be a broadcast view (lane stride 0): one problem's
    theta reaches every lane without materialising ``(n_theta, B)``.
    """
    if centers.device.type != "cuda":
        raise ValueError(f"genz_malik_eval_soa runs on CUDA tensors, got {centers.device}")
    if centers.dtype not in _SYMBOLS:
        raise TypeError(f"dtype must be float32 or float64, got {centers.dtype}")
    if centers.ndim != 2 or halfw.shape != centers.shape:
        raise ValueError(
            f"centers and halfw must both be (d, B), got {tuple(centers.shape)} "
            f"and {tuple(halfw.shape)}"
        )
    if halfw.dtype != centers.dtype or halfw.device != centers.device:
        raise ValueError("centers and halfw must share dtype and device")
    if not (centers.is_contiguous() and halfw.is_contiguous()):
        raise ValueError("centers and halfw must be contiguous (d, B) arrays")
    d, b = centers.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the GM kernel takes 1 <= d <= {MAX_D}, got d={d}")
    if kernel_id not in range(10):
        raise ValueError(f"unknown kernel id {kernel_id}")
    need = THETA_ROWS_PER_AXIS.get(kernel_id, 0) * d
    th_ptr, th_rs, th_ls = None, 0, 0
    if need:
        if theta_rows is None:
            raise ValueError(f"kernel id {kernel_id} needs {need} theta rows")
        if tuple(theta_rows.shape) != (need, b):
            raise ValueError(
                f"theta_rows must be ({need}, {b}), got {tuple(theta_rows.shape)}"
            )
        if theta_rows.dtype != centers.dtype or theta_rows.device != centers.device:
            raise ValueError("theta_rows must share the dtype and device of centers")
        th_rs, th_ls = theta_rows.stride()
        if th_rs < 0 or th_ls < 0:
            raise ValueError("theta_rows must have non-negative strides")
        th_ptr = theta_rows.data_ptr()
    elif theta_rows is not None:
        raise ValueError(f"kernel id {kernel_id} takes no theta rows")
    block = resolve_block(block_regions)

    i7 = torch.empty(b, dtype=centers.dtype, device=centers.device)
    i5 = torch.empty_like(i7)
    i3 = torch.empty_like(i7)
    diffs = torch.empty_like(centers)
    if b == 0:
        return i7, i5, i3, diffs
    consts = _consts(d)
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    # the launcher sets the CUDA device; the guard restores the caller's
    with torch.cuda.device(centers.device):
        rc = _entry(centers.dtype)(
            centers.device.index,
            kernel_id, d, b, block,
            centers.data_ptr(), halfw.data_ptr(), th_ptr, th_rs, th_ls,
            i7.data_ptr(), i5.data_ptr(), i3.data_ptr(), diffs.data_ptr(),
            ctypes.cast(consts, ctypes.c_void_p), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"genz_malik_eval kernel launch failed: cudaError_t {rc} (kernel id "
            f"{kernel_id}, d={d}, {centers.dtype}, B={b}, block={block})"
        )
    global _launches
    _launches += 1
    return i7, i5, i3, diffs
