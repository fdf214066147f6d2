"""The VEGAS sample reductions: launch wrapper of csrc/vegas_sums.cu and its
plain PyTorch version.

Replaces the three ``jax.ops.segment_sum`` of ``src/repro/mc/engine.py:196-202``
(per-cube sums of ``w`` and ``w^2``, per-(axis, bin) sums of ``w^2``).  On
the card ``index_add_`` adds with atomics, in an order that changes from run
to run; the kernel adds every sum in one fixed order, so an estimate is the
same bits on every run and at every rank count.

The order: a shard is cut into chunks of :data:`CHUNK` samples (the last
one shorter); within a chunk a sum runs in sample order, and the chunk
partials are added in chunk order, from zero.  A shard of at most
:data:`CHUNK` samples is summed strictly in sample order, as the
reference's ``segment_sum`` does.

:func:`vegas_sums` launches the kernel for CUDA tensors and runs
:func:`vegas_sums_ref` for CPU tensors.  The plain version does the same
arithmetic (two ``index_add_`` passes, which add in source order on the
CPU), so the two give the same bits on the same inputs.  The wrapper
counts its calls (:func:`launch_count`; a call is the kernel's two
launches: chunk partials, then the in-order combine).  The chunk launch
sorts each chunk's samples by bin, stably, and adds each bin's run in
sample order: in one pass up to 64 bins, in 6-bit digit passes above;
:func:`plan` reports which, with its shared memory and occupancy.

Within a chunk's range of cubes every cube is one piece of the chunk's
scratch row, so at most :data:`CHUNK` cubes may meet one chunk (the
engine's cubes hold at least ``mc_min_per_cube`` >= 2 samples each).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

CHUNK = 1024  # kChunk of csrc/vegas_sums.cu: samples per chunk of the sums' order

_SYMBOLS = {torch.float64: "vegas_sums_f64", torch.float32: "vegas_sums_f32"}
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = build.load("vegas_sums")
    if lib.vegas_sums_chunk() != CHUNK:
        raise RuntimeError(f"csrc/vegas_sums.cu has kChunk {lib.vegas_sums_chunk()}, not {CHUNK}")
    fn = getattr(lib, _SYMBOLS[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,  # device
        ctypes.c_longlong,  # P problems
        ctypes.c_longlong,  # shards given
        ctypes.c_longlong,  # samples per shard
        ctypes.c_longlong,  # global index of the first shard given
        ctypes.c_longlong,  # M cubes
        ctypes.c_int,  # d
        ctypes.c_int,  # bins per axis
        ctypes.c_void_p,  # w (P, n)
        ctypes.c_void_p,  # y (d, P, n)
        ctypes.c_void_p,  # cum (P, M) int64
        ctypes.c_void_p,  # scratch: piece sums of w (P, n_shards, C, CHUNK)
        ctypes.c_void_p,  # scratch: piece sums of w * w
        ctypes.c_void_p,  # scratch: first cube of each chunk (P, n_shards, C) int64
        ctypes.c_void_p,  # scratch: chunk bin sums (P, n_shards, C, d, nb)
        ctypes.c_void_p,  # s1 (P, n_shards, M)
        ctypes.c_void_p,  # s2
        ctypes.c_void_p,  # g (P, n_shards, d, nb)
        ctypes.c_void_p,  # stream
    ]
    return fn


def plan(dtype: torch.dtype, n_bins: int, device=None) -> dict:
    """The chunk launch on a CUDA device at ``n_bins`` bins: its path
    (``"one_pass"`` up to 64 bins, else ``"digit_passes"``), dynamic shared
    bytes per block, and the blocks per SM that
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives."""
    dev = torch.device("cuda" if device is None else device)
    lib = build.load("vegas_sums")
    lib.vegas_sums_plan.restype = ctypes.c_int
    lib.vegas_sums_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    rc = lib.vegas_sums_plan(index, int(dtype == torch.float64), n_bins, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"vegas_sums_plan failed: cudaError_t {rc} (nb={n_bins})")
    return dict(path="digit_passes" if out[0] else "one_pass", smem_bytes=out[1],
                blocks_per_sm=out[2])


def _check(w, y, cum, n_bins, shard0, shard_size):
    if w.ndim != 2 or y.ndim != 3 or cum.ndim != 2:
        raise ValueError(
            f"expected w (P, n), y (d, P, n), cum (P, M); got {tuple(w.shape)}, "
            f"{tuple(y.shape)}, {tuple(cum.shape)}"
        )
    P, n = w.shape
    if y.shape[1:] != w.shape or cum.shape[0] != P:
        raise ValueError(
            f"shapes disagree: w {tuple(w.shape)}, y {tuple(y.shape)}, cum {tuple(cum.shape)}"
        )
    if shard_size < 1 or n % shard_size or n == 0:
        raise ValueError(f"n={n} samples must be whole shards of {shard_size}")
    if shard0 < 0 or n_bins < 1:
        raise ValueError(f"bad shard0={shard0} or n_bins={n_bins}")
    if w.dtype not in _SYMBOLS or y.dtype != w.dtype or cum.dtype != torch.int64:
        raise TypeError(
            f"w and y must share float32 or float64 and cum be int64; got {w.dtype}, "
            f"{y.dtype}, {cum.dtype}"
        )
    if not (w.device == y.device == cum.device):
        raise ValueError("w, y and cum must lie on one device")
    return P, n // shard_size


def vegas_sums_ref(w, y, cum, n_bins: int, shard0: int, shard_size: int):
    """The plain version: the kernel's sums, as two ``index_add_`` passes.

    Returns ``(s1, s2, g)``: ``(P, n_shards, M)``, ``(P, n_shards, M)`` and
    ``(P, n_shards, d, n_bins)``.  Sample ``j`` of problem ``p`` is global
    sample ``shard0 * shard_size + j``; its cube is the interval of ``cum``
    that holds that index, its bin on axis ``i`` ``clip(int(y * n_bins))``.
    The first pass sums each chunk's cube pieces and bins in sample order,
    the second adds the chunk partials in chunk order (on the CPU
    ``index_add_`` adds in source order).
    """
    P, n_shards = _check(w, y, cum, n_bins, shard0, shard_size)
    d, M, n = y.shape[0], cum.shape[1], w.shape[1]
    dev, L = w.device, CHUNK
    C = -(-shard_size // L)
    j = torch.arange(n, device=dev)
    local = j % shard_size
    chunk = (torch.arange(P, device=dev)[:, None] * n_shards + j // shard_size) * C + local // L
    cube = torch.searchsorted(cum, (shard0 * shard_size + j).expand(P, n).contiguous(), right=True)
    # the first and last cube of every (problem, shard, chunk)
    firsts = torch.arange(0, shard_size, L, device=dev)
    lasts = torch.clamp(firsts + L, max=shard_size) - 1
    starts = (torch.arange(n_shards, device=dev)[:, None] * shard_size + firsts).reshape(-1)
    ends = (torch.arange(n_shards, device=dev)[:, None] * shard_size + lasts).reshape(-1)
    kfirst = cube[:, starts].reshape(-1)  # (P * n_shards * C,)
    klast = cube[:, ends].reshape(-1)
    w2 = w * w
    # pass 1: cube pieces (chunk, cube - kfirst) and chunk bins
    piece = (chunk * L + cube - kfirst[chunk]).reshape(-1)
    part1 = torch.zeros(P * n_shards * C * L, dtype=w.dtype, device=dev)
    part2 = torch.zeros_like(part1)
    part1.index_add_(0, piece, w.reshape(-1))
    part2.index_add_(0, piece, w2.reshape(-1))
    b = torch.clamp((y * n_bins).long(), 0, n_bins - 1)  # (d, P, n)
    axis = torch.arange(d, device=dev)[:, None, None]
    partg = torch.zeros(P * n_shards * C * d * n_bins, dtype=w.dtype, device=dev)
    partg.index_add_(0, ((chunk[None] * d + axis) * n_bins + b).reshape(-1),
                     w2.expand(d, P, n).reshape(-1))
    # pass 2: chunk partials into the outputs, in chunk order; unused piece
    # slots go to a spare last entry
    ks = kfirst[:, None] + torch.arange(L, device=dev)
    row = (torch.arange(P * n_shards * C, device=dev) // C)[:, None]
    ids = torch.where(ks <= klast[:, None], row * M + ks, P * n_shards * M).reshape(-1)
    s1 = torch.zeros(P * n_shards * M + 1, dtype=w.dtype, device=dev).index_add_(0, ids, part1)
    s2 = torch.zeros_like(s1).index_add_(0, ids, part2)
    dnb = d * n_bins
    gids = (row * dnb + torch.arange(dnb, device=dev)).reshape(-1)
    g = torch.zeros(P * n_shards * dnb, dtype=w.dtype, device=dev).index_add_(0, gids, partg)
    return (
        s1[:-1].view(P, n_shards, M),
        s2[:-1].view(P, n_shards, M),
        g.view(P, n_shards, d, n_bins),
    )


def vegas_sums(w, y, cum, n_bins: int, shard0: int, shard_size: int):
    """Per-cube and per-bin sums of the samples of whole shards.

    ``w`` (P, n) are the weighted integrand values and ``y`` (d, P, n) the
    uniform coordinates of P problems' samples, ``n`` a multiple of
    ``shard_size``, sample ``j`` being global sample ``shard0 * shard_size +
    j``; ``cum`` (P, M) the cumulative per-cube counts (int64).  Returns
    ``(s1, s2, g)`` as :func:`vegas_sums_ref`.  CUDA tensors go through the
    kernel, CPU tensors through the plain version.
    """
    if w.device.type == "cpu":
        return vegas_sums_ref(w, y, cum, n_bins, shard0, shard_size)
    if w.device.type != "cuda":
        raise ValueError(f"vegas_sums runs on CUDA or CPU tensors, got {w.device}")
    P, n_shards = _check(w, y, cum, n_bins, shard0, shard_size)
    if not (w.is_contiguous() and y.is_contiguous() and cum.is_contiguous()):
        raise ValueError("w, y and cum must be contiguous")
    if n_bins > 65535:
        raise ValueError(f"the kernel takes at most 65535 bins, got {n_bins}")
    d, M, dev = y.shape[0], cum.shape[1], w.device
    C = -(-shard_size // CHUNK)
    part1 = torch.empty((P, n_shards, C, CHUNK), dtype=w.dtype, device=dev)
    part2 = torch.empty_like(part1)
    kfirst = torch.empty((P, n_shards, C), dtype=torch.int64, device=dev)
    partg = torch.empty((P, n_shards, C, d, n_bins), dtype=w.dtype, device=dev)
    s1 = torch.empty((P, n_shards, M), dtype=w.dtype, device=dev)
    s2 = torch.empty_like(s1)
    g = torch.empty((P, n_shards, d, n_bins), dtype=w.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _entry(w.dtype)(
            dev.index, P, n_shards, shard_size, shard0, M, d, n_bins,
            w.data_ptr(), y.data_ptr(), cum.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            kfirst.data_ptr(), partg.data_ptr(), s1.data_ptr(), s2.data_ptr(), g.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"vegas_sums kernel launch failed: cudaError_t {rc} (P={P}, shards={n_shards}, "
            f"Ns={shard_size}, M={M}, d={d}, nb={n_bins}, {w.dtype})"
        )
    global _launches
    _launches += 1
    return s1, s2, g
