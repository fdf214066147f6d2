"""Launch wrappers of the redistribution round's two CUDA kernels
(csrc/redistribute_round.cu): pack and splice.

One rank's round, as :func:`repro_torch.core.redistribution.redistribute`
runs it on the card: :func:`round_pack` computes the rank's plan from every
rank's live count and packs the rows it sends; the payloads then move one
ring step (``Ranks.ppermute``); :func:`round_splice` writes the block the
rank received into its store and retires the rows it sent.  Their plain
versions are :func:`repro_torch.kernels.ref.round_pack_ref` and
:func:`~repro_torch.kernels.ref.round_splice_ref`, which the CPU runs; the
kernels give their bits.

The wrappers take CUDA tensors only (a CPU tensor raises: the caller picks
the plain version), launch on the current stream of the tensors' device
without synchronising, and count their launches (:func:`launch_count`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# plan entries: the rows sent, the rows received (before the store's end
# cuts them), the first row of the window, and the count after the round
PLAN = ("n_send", "n_recv", "base", "after")

_FLOATS = {torch.float64: "f64", torch.float32: "f32"}
_launches = {"pack": 0, "splice": 0}


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (``"pack"`` or ``"splice"``) since the last
    :func:`reset_launch_count`."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for kernel in _launches:
        _launches[kernel] = 0


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype):
    fn = getattr(build.load("redistribute_round"), f"redistribute_{kernel}_{_FLOATS[dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = {
        # counts, n, r, shift, cap, limit, C, d, centers, halfw, plan, payload, stream
        "pack": [_P, _I, _I, _I, _LL, _LL, _LL, _I, _P, _P, _P, _P, _P],
        # cap, C, d, plan, incoming, centers, halfw, est, err, axis, active, fresh, stream
        "splice": [_LL, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    }[kernel]
    return fn


def _check_cuda(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(
            f"the round's kernels take CUDA tensors, got {dev}; on the CPU run "
            "kernels.ref.round_pack_ref / round_splice_ref"
        )
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}: a rank's round runs on one device")
        if not t.is_contiguous():
            raise ValueError("the round's kernels take contiguous tensors")
    return dev


def _launch(kernel: str, dtype: torch.dtype, dev: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _entry(kernel, dtype)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"redistribute_{kernel} launch failed: cudaError_t {rc} ({dtype})")
    _launches[kernel] += 1


def round_pack(counts, rank: int, shift: int, cap: int, limit: int, centers, halfw):
    """Rank ``rank``'s plan and payload in a round at ring distance ``shift``.

    ``counts`` (n,) int64 are every rank's live count; ``centers`` and
    ``halfw`` (C, d) the rank's store.  Returns ``plan`` (4,) int64, whose
    first three entries (:data:`PLAN`) are written here and the last by
    :func:`round_splice`, and ``payload`` (min(cap, C), 2d): the centres and
    half-widths of rows ``(base + j) mod C`` for ``j < n_send``, zero after.
    """
    dev = _check_cuda(counts, centers, halfw)
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise TypeError(f"counts must be (n,) int64, got {tuple(counts.shape)} {counts.dtype}")
    if centers.dtype not in _FLOATS or halfw.dtype != centers.dtype or halfw.shape != centers.shape:
        raise TypeError("centers and halfw must be (C, d) of one float type")
    C, d = centers.shape
    plan = torch.empty(len(PLAN), dtype=torch.int64, device=dev)
    payload = torch.empty((min(cap, C), 2 * d), dtype=centers.dtype, device=dev)
    _launch("pack", centers.dtype, dev, counts.data_ptr(), counts.shape[0], rank, shift, cap,
            limit, C, d, centers.data_ptr(), halfw.data_ptr(), plan.data_ptr(),
            payload.data_ptr())
    return plan, payload


def round_splice(plan, incoming, centers, halfw, est, err, axis, active, fresh):
    """Write the received block ``incoming`` into the rank's store, in place,
    and retire the rows it sent, as :func:`round_pack`'s ``plan`` says.

    Returns the rank's live count after the round and the rows it sent, as
    int64 device scalars (views of ``plan``).
    """
    dev = _check_cuda(plan, incoming, centers, halfw, est, err, axis, active, fresh)
    C, d = centers.shape
    dtype = centers.dtype
    if not (dtype in _FLOATS and incoming.dtype == halfw.dtype == est.dtype == err.dtype == dtype):
        raise TypeError("incoming, centers, halfw, est and err must share one float type")
    if axis.dtype != torch.int32 or active.dtype != torch.bool or fresh.dtype != torch.bool:
        raise TypeError("axis must be int32, active and fresh bool")
    if plan.dtype != torch.int64 or plan.shape != (len(PLAN),):
        raise TypeError("plan must be round_pack's (4,) int64")
    if incoming.shape[1] != 2 * d or any(t.shape != (C,) for t in (est, err, axis, active, fresh)):
        raise ValueError("incoming must be (P, 2d) and est, err, axis, active, fresh (C,)")
    cap = incoming.shape[0]
    if cap != min(cap, C):
        raise ValueError(f"incoming has {cap} rows, more than the store's {C}")
    _launch("splice", dtype, dev, cap, C, d, plan.data_ptr(), incoming.data_ptr(),
            centers.data_ptr(), halfw.data_ptr(), est.data_ptr(), err.data_ptr(),
            axis.data_ptr(), active.data_ptr(), fresh.data_ptr())
    n_send, _, _, after = plan.unbind()
    return after, n_send
