"""Launch wrappers of the redistribution round's CUDA kernels
(csrc/redistribute_round.cu): the round, one launch a device over every
rank on it, and the pack of donors whose receiver lives on another device.

:class:`RoundKernels` launches both on one device.  Its
:meth:`~RoundKernels.round` takes, for each rank of the launch, its store
and the source of its receive: where the donor lives on the same device,
the donor's index among the launch's stores (the receiver reads the
donor's rows directly), else a staged ``(P, 2d)`` block that
:meth:`~RoundKernels.pack` wrote on the donor's device and one copy moved
here.  Their plain versions are :func:`repro_torch.kernels.ref.round_ref`
and :func:`~repro_torch.kernels.ref.round_pack_ref`, with the same
signatures; the CPU runs them, and the kernels give their bits.

A :class:`RoundKernels` checks every tensor the first time it sees it
(device, type, shape, contiguity, against the layout of the first call's
stores) and keeps it, so a later round over the same stores (the driver
updates them in place) only finds them the same objects and reads their
pointers; stores it has not seen are checked again, and one of another
layout raises.  The counts are checked every call.  The kernels take CUDA
tensors only (a CPU tensor raises: the caller picks the plain version),
launch on the current stream of the device without synchronising, and
count their launches (:func:`launch_count`).  One launch serves at most :data:`MAX_LOCAL` ranks
of a ring of at most :data:`MAX_RANKS`; beyond that they raise.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from repro_torch.kernels import build

KERNELS = ("round", "pack")
# a store's per-row fields, in the order the round takes them
FIELDS = ("centers", "halfw", "est", "err", "axis", "active", "fresh")
MAX_RANKS = 64  # ranks of the ring: the count pointers a launch carries
MAX_LOCAL = 32  # ranks one launch serves (the kernels' parameter space)

# the int64 words of the kernels' argument structs
_HEADER = 7 + MAX_RANKS  # n, shift, cap, limit, C, d, n_local, counts[MAX_RANKS]
_RANK_SLOT = 11  # 7 store pointers, src_centers, src_halfw, staged, rank
_PACK_SLOT = 4  # centers, halfw, block, rank
_ROUND_WORDS = _HEADER + 1 + MAX_LOCAL * _RANK_SLOT  # the header, out, the slots
_PACK_WORDS = _HEADER + MAX_LOCAL * _PACK_SLOT

_FLOATS = {torch.float64: "f64", torch.float32: "f32"}
_STORE_ROLES = ("rows", "rows", "column", "column", "axis", "flag", "flag")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (``"round"`` or ``"pack"``) since the last
    :func:`reset_launch_count`."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for kernel in _launches:
        _launches[kernel] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("redistribute_round")
    lib.redistribute_round_layout.restype = None
    lib.redistribute_round_layout.argtypes = [ctypes.c_void_p]
    got = (ctypes.c_longlong * 4)()
    lib.redistribute_round_layout(got)
    if tuple(got) != (MAX_RANKS, MAX_LOCAL, _ROUND_WORDS, _PACK_WORDS):
        raise RuntimeError(f"redistribute_round.cu's argument layout {tuple(got)} is not this "
                           f"wrapper's {(MAX_RANKS, MAX_LOCAL, _ROUND_WORDS, _PACK_WORDS)}")
    for kernel in KERNELS:
        for suffix in _FLOATS.values():
            fn = getattr(lib, f"redistribute_{kernel}_{suffix}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.redistribute_launch_floor.restype = ctypes.c_int
    lib.redistribute_launch_floor.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


def launch_floor(device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the launch
    floor that the round is read against (``gm_perf.py::time_round``)."""
    dev = torch.device(device)
    rc = _library().redistribute_launch_floor(dev.index or 0,
                                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch_floor failed: cudaError_t {rc}")


class RoundKernels:
    """The round's two kernels on one device, with the checks of the
    tensors they have seen kept (see the module docstring)."""

    def __init__(self):
        self._layout = None  # (device, dtype, C, d) of the first call's stores
        self._stores = []  # the last round's store tensors, checked, in order
        self._seen = {}  # id -> (tensor, role) of the other tensors checked
        self._round_args = (ctypes.c_longlong * _ROUND_WORDS)()
        self._pack_args = (ctypes.c_longlong * _PACK_WORDS)()

    def round(self, counts, ranks, shift: int, cap: int, limit: int, stores, sources):
        """One round of the ranks ``ranks`` (their ring indices) at ring
        distance ``shift``, in place, in one launch.

        ``counts`` are every rank's live count as int64 on this device: n
        scalars, or one ``(n,)`` tensor.  ``stores`` are the ranks' stores,
        each its :data:`FIELDS` tensors; ``sources`` per rank its donor's
        index in ``stores``, or a staged ``(min(cap, C), 2d)`` block.
        Returns each rank's live count after the round and the rows it
        sent, int64 scalars viewing one fresh ``(len(ranks), 2)`` tensor.
        """
        dev, dtype, C, d = self._start(stores)
        n_local = self._local(ranks, stores, sources)
        P = min(cap, C)
        a = self._round_args
        n = self._header(a, counts, shift, cap, limit, C, d, n_local)
        tensors = [t for store in stores for t in store]
        if not (len(tensors) == len(self._stores) and all(map(operator.is_, tensors,
                                                               self._stores))):
            for store in stores:
                if len(store) != len(FIELDS):
                    raise ValueError(f"a store is its {len(FIELDS)} fields {FIELDS}")
                for t, role in zip(store, _STORE_ROLES):
                    self._check(t, role)
            self._stores = tensors
        ptrs = [t.data_ptr() for t in tensors]
        out = torch.empty(2 * n_local, dtype=torch.int64, device=dev)
        a[_HEADER] = out.data_ptr()
        k = _HEADER + 1
        for i, (r, source) in enumerate(zip(ranks, sources)):
            if not 0 <= r < n:
                raise ValueError(f"rank {r} outside a ring of {n}")
            a[k:k + 7] = ptrs[7 * i:7 * i + 7]
            if isinstance(source, torch.Tensor):
                block = self._ptr(source, ("block", P))
                a[k + 7:k + 11] = [block, block + d * source.element_size(), 1, r]
            elif 0 <= source < n_local:
                a[k + 7:k + 11] = [ptrs[7 * source], ptrs[7 * source + 1], 0, r]
            else:
                raise ValueError(f"donor index {source} outside the launch's {n_local} stores")
            k += _RANK_SLOT
        self._launch("round", dtype, dev, a)
        vals = out.unbind()
        return list(vals[0::2]), list(vals[1::2])

    def pack(self, counts, ranks, shift: int, cap: int, limit: int, stores, blocks) -> None:
        """Each donor's ``(min(cap, C), 2d)`` block, written in place in one
        launch: ``stores`` are the donors' ``(centers, halfw)``, ``blocks``
        their blocks; row j holds the centres and half-widths of the donor's
        row ``(base + j) mod C`` for j below the rows it sends, zero after.
        The work does not depend on the counts."""
        dev, dtype, C, d = self._start(stores)
        n_local = self._local(ranks, stores, blocks)
        P = min(cap, C)
        a = self._pack_args
        n = self._header(a, counts, shift, cap, limit, C, d, n_local)
        k = _HEADER
        for r, (centers, halfw), block in zip(ranks, stores, blocks):
            if not 0 <= r < n:
                raise ValueError(f"rank {r} outside a ring of {n}")
            a[k:k + 4] = [self._ptr(centers, "rows"), self._ptr(halfw, "rows"),
                          self._ptr(block, ("block", P)), r]
            k += _PACK_SLOT
        self._launch("pack", dtype, dev, a)

    def _start(self, stores):
        if self._layout is None:
            if not stores:
                raise ValueError("a launch takes at least one rank")
            centers = stores[0][0]
            dev = centers.device
            if dev.type != "cuda":
                raise ValueError(
                    f"the round's kernels take CUDA tensors, got {dev}; on the CPU run "
                    "kernels.ref.round_ref / round_pack_ref"
                )
            if centers.dtype not in _FLOATS or centers.dim() != 2:
                raise TypeError(f"centers must be (C, d) float64 or float32, got "
                                f"{tuple(centers.shape)} {centers.dtype}")
            C, d = centers.shape
            self._layout = (dev, centers.dtype, C, d)
        return self._layout

    @staticmethod
    def _local(ranks, stores, sources) -> int:
        n_local = len(stores)
        if not 0 < n_local <= MAX_LOCAL:
            raise ValueError(f"a launch takes 1 to {MAX_LOCAL} ranks, got {n_local}")
        if len(ranks) != n_local or len(sources) != n_local:
            raise ValueError("give one rank index and one source per store")
        return n_local

    def _header(self, a, counts, shift, cap, limit, C, d, n_local) -> int:
        """Write the header words; returns n, the ranks of the ring."""
        dev = self._layout[0]
        if isinstance(counts, torch.Tensor):
            if counts.dtype != torch.int64 or counts.dim() != 1 or not counts.is_contiguous():
                raise TypeError(f"counts must be (n,) int64, got {tuple(counts.shape)} {counts.dtype}")
            if counts.get_device() != self._stores_device():
                raise ValueError(f"counts on {counts.device}, the round on {dev}")
            n = counts.shape[0]
            base, size = counts.data_ptr(), counts.element_size()
            ptrs = [base + i * size for i in range(n)]
        else:
            for t in counts:
                if t.dtype != torch.int64 or t.dim() != 0:
                    raise TypeError(f"each count must be an int64 scalar, got {t.dtype} "
                                    f"{tuple(t.shape)}")
                if t.get_device() != self._stores_device():
                    raise ValueError(f"a count on {t.device}, the round on {dev}")
            ptrs = [t.data_ptr() for t in counts]
            n = len(ptrs)
        if not 0 < n <= MAX_RANKS:
            raise ValueError(f"the round's kernels take rings of 1 to {MAX_RANKS} ranks, got {n}")
        if cap < 1:
            raise ValueError(f"message cap {cap} < 1")
        a[0:7] = [n, shift, cap, limit, C, d, n_local]
        a[7:7 + n] = ptrs
        return n

    def _stores_device(self) -> int:
        """The layout's device as ``Tensor.get_device`` gives it (cheaper
        to compare than a ``torch.device``)."""
        dev = self._layout[0]
        return -1 if dev.index is None else dev.index

    def _ptr(self, t: torch.Tensor, role) -> int:
        hit = self._seen.get(id(t))
        if hit is None or hit[0] is not t or hit[1] != role:
            self._check(t, role)
            self._seen[id(t)] = (t, role)
        return t.data_ptr()

    def _check(self, t, role) -> None:
        dev, dtype, C, d = self._layout
        if role == "rows":
            want = (dtype, (C, d))
        elif role == "column":
            want = (dtype, (C,))
        elif role == "axis":
            want = (torch.int32, (C,))
        elif role == "flag":
            want = (torch.bool, (C,))
        else:  # ("block", P)
            want = (dtype, (role[1], 2 * d))
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}: a launch runs on one device")
        if (t.dtype, tuple(t.shape)) != want:
            raise TypeError(f"expected {want[0]} {want[1]}, got {t.dtype} {tuple(t.shape)} (the "
                            f"stores' layout is the first round's: {dtype} C={C} d={d})")
        if not t.is_contiguous():
            raise ValueError("the round's kernels take contiguous tensors")

    @staticmethod
    def _launch(kernel: str, dtype: torch.dtype, dev: torch.device, args) -> None:
        fn = getattr(_library(), f"redistribute_{kernel}_{_FLOATS[dtype]}")
        # the current stream's handle, without making a Stream object
        rc = fn(ctypes.addressof(args), dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
        if rc != 0:
            raise RuntimeError(f"redistribute_{kernel} launch failed: cudaError_t {rc} ({dtype})")
        _launches[kernel] += 1

