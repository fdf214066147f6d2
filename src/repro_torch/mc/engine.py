"""VEGAS+ adaptive importance-sampling engine (the second backend).

The port of the JAX package's ``repro.mc.engine``.  One MC *iteration*:

1. **sample**: ``cfg.mc_samples`` stratified points.  The unit cube of
   uniform coordinates is cut into ``n_strat^d`` hypercubes with adaptive
   per-cube counts (:mod:`repro_torch.mc.stratified`), and each point is
   pushed through the per-axis importance grid (:mod:`repro_torch.mc.grid`),
   picking up the map's Jacobian;
2. **evaluate**: the integrand (a torch callable ``f((d, N)) -> (N,)``, a
   registry entry, or a theta-parameterised family) at the mapped points,
   as torch operations on the device;
3. **accumulate**: per-stratum sums of ``f·J`` and ``(f·J)^2`` give the
   iteration's estimate ``I_t`` and variance ``sigma_t^2``; per-axis per-bin
   sums of ``(f·J)^2`` feed the grid.  These sums are
   :func:`repro_torch.kernels.vegas_sums.vegas_sums`, a CUDA kernel that adds
   in a fixed order on the card;
4. **refine**: damped grid refinement + VEGAS+ count reallocation.

Across iterations the estimator is the inverse-variance weighted average
with a chi^2/dof guard (the reported error is inflated by
``sqrt(chi^2/dof)`` when the iterations disagree); the first
``cfg.mc_warmup`` iterations adapt only.

**Shards.**  Every sample reduction runs in ``cfg.mc_shards`` fixed shards
(shard ``s`` owns the global sample indices ``[s Ns, (s + 1) Ns)``), and the
shard partials combine in a fixed left-to-right sum.  The uniforms of a
shard come from a ``torch.Generator`` seeded by a hash of (the problem's
stream, the iteration, the shard): a problem's stream is its ``mc_seed``
(and, in the service pool, its slot and admission number).  So a shard's
partials are a function of the shard alone, and
:func:`~repro_torch.mc.multi_device.integrate_vegas_distributed`, which
gives whole shards to ranks and gathers their partials in shard order, is
bit-identical to one rank at any rank count dividing ``mc_shards`` (on one
device type: CUDA generators are Philox, CPU ones mt19937, so the card's
numbers are not the CPU's).

**Batch axis.**  The iterate is written once over a leading problem axis
``P``: ``P = 1`` for one integral, the live slots for
:class:`VegasBatchEngine`.  The state's iteration counters are host arrays:
the host knows them without reading the device, and the draws' seeds need
them.  The host reads one stacked set of values per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveResult, resolve_device
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand, get as get_integrand
from repro_torch.core.integrands import get_param, parse_spec
from repro_torch.core.ranks import Ranks, copy_to, cuda_devices, rank_device, to_device
from repro_torch.kernels.vegas_sums import vegas_sums
from repro_torch.mc import grid as grid_lib
from repro_torch.mc import stratified

# A result needs at least this many accumulated (post-warmup) iterations
# before it may report convergence: with one there is no chi^2 dof, so a
# lucky first iteration cannot end the run on an untrustworthy error bar.
MIN_ACCUMULATED = 2

# values of one iteration the host reads, stacked into one transfer
_READ = ("integral", "error", "chi2_dof", "nonfinite")

# named ranges of an iteration's stages, for torch.profiler (gm_perf.py
# profile --drivers vegas); a few microseconds of host time when no
# profiler runs
_stage = torch.profiler.record_function

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit words that scatters
    nearby inputs."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed that is a function of ``parts`` alone."""
    h = 0
    for v in parts:
        h = _mix64(h ^ (int(v) & _MASK64))
    return h >> 1


@dataclasses.dataclass
class VegasState:
    """Fixed-shape MC state of ``P`` problems (leading axis of every field).

    Tensors live on one device; the counters are host arrays.
    """

    edges: torch.Tensor  # (P, d, mc_bins + 1) importance-grid edges in [0, 1]
    strat_w: torch.Tensor  # (P, M) damped per-cube allocation weights
    sum_wi: torch.Tensor  # (P,) sum I_t / sigma_t^2 over accumulated iterations
    sum_w: torch.Tensor  # (P,) sum 1 / sigma_t^2
    sum_wi2: torch.Tensor  # (P,) sum I_t^2 / sigma_t^2 (chi^2 bookkeeping)
    stream: np.ndarray  # (P,) int64 seed of each problem's draws
    it: np.ndarray  # (P,) int64 iterations run (incl. warmup)
    n_acc: np.ndarray  # (P,) int64 accumulated (post-warmup) iterations
    n_evals: np.ndarray  # (P,) float64 integrand evaluations spent


@dataclasses.dataclass
class VegasResult(AdaptiveResult):
    """MC result; ``error`` is the chi^2-inflated weighted-average sigma."""

    chi2_dof: float = 0.0

    def summary(self) -> str:
        return (
            f"I={self.integral:.15e} eps={self.error:.3e} [{self.status}] "
            f"iters={self.iterations} evals={self.n_evals:.3g} "
            f"chi2/dof={self.chi2_dof:.2f}"
        )


def mc_layout(cfg: QuadratureConfig) -> tuple[int, int]:
    """Static stratification layout ``(n_strat, n_cubes)`` for ``cfg``."""
    n_strat = stratified.choose_n_strat(cfg.d, cfg.mc_samples, cfg.mc_min_per_cube)
    return n_strat, n_strat**cfg.d


def init_state(cfg: QuadratureConfig, device="cpu", n: int = 1) -> VegasState:
    """``n`` fresh problems on ``device``, each drawing from the stream
    ``stream_seed(cfg.mc_seed)`` (the service pool reseeds a slot's stream
    at admission)."""
    dtype = getattr(torch, cfg.dtype)
    _, m = mc_layout(cfg)
    edges = grid_lib.uniform_edges(cfg.d, cfg.mc_bins, dtype, device)
    return VegasState(
        edges=edges.expand(n, *edges.shape).contiguous(),
        strat_w=torch.full((n, m), 1.0 / m, dtype=dtype, device=device),
        sum_wi=torch.zeros(n, dtype=dtype, device=device),
        sum_w=torch.zeros(n, dtype=dtype, device=device),
        sum_wi2=torch.zeros(n, dtype=dtype, device=device),
        stream=np.full(n, stream_seed(cfg.mc_seed), np.int64),
        it=np.zeros(n, np.int64),
        n_acc=np.zeros(n, np.int64),
        n_evals=np.zeros(n, np.float64),
    )


def _ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right sum over ``dim`` (the shard axis): ``torch.sum`` may
    associate differently at different lengths, this order is pinned."""
    out = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        out = out + x.select(dim, k)
    return out


def make_iterate(
    cfg: QuadratureConfig,
    fn: Callable[..., torch.Tensor],
    *,
    has_theta: bool = False,
    devices: Sequence = ("cuda",),
    uniforms: Optional[Callable[[int, int], Any]] = None,
) -> Callable:
    """Build the single-iteration update.

    Returns ``iterate(state[, theta]) -> (state, metrics)``: ``metrics`` holds
    device tensors (P,) ``integral``, ``error``, ``chi2_dof``, ``nonfinite``,
    ``it_integral`` and ``it_sigma`` (the weighted average, falling back to
    the iteration's own estimate during warmup, and the iteration's values)
    and the host array ``n_acc``.  ``state`` lies on the first device and
    comes back there.

    ``fn`` is ``f(x)`` on ``(d, N)`` coordinates, or with ``has_theta``
    ``f(x, theta)`` on ``(d, P, N)`` coordinates with theta leaves of shape
    ``(d, P, 1)`` (the service pool's slots).

    ``devices`` lists one device per rank (it may repeat one): rank r draws
    and reduces shards ``[r S/n, (r+1) S/n)`` of the ``S = mc_shards``, and
    the partials are gathered to the first rank in shard order.

    ``uniforms(it, shard)``, for tests only, replaces the generator: it
    returns the ``(d, Ns)`` uniforms of shard ``shard`` at iteration ``it``
    (one problem).
    """
    cfg = cfg.validate()
    d, nb = cfg.d, cfg.mc_bins
    n_strat, M = mc_layout(cfg)
    N, S = cfg.mc_samples, cfg.mc_shards
    Ns = N // S
    dtype = getattr(torch, cfg.dtype)
    ranks = Ranks(devices)
    if S % ranks.n:
        raise ValueError(
            f"mc_shards={S} must be divisible by the rank count ({ranks.n}): "
            "shards are the unit of multi-rank division"
        )
    local = S // ranks.n
    lo_np = np.asarray(cfg.lo(), np.float64)
    width_np = np.asarray(cfg.hi(), np.float64) - lo_np
    volume = float(np.prod(width_np))
    # per device: the domain's origin and width as (d, 1, 1) columns, and
    # the generator the draws reseed
    per_dev = {}
    for dev in ranks.devices:
        if dev not in per_dev:
            per_dev[dev] = (
                torch.as_tensor(lo_np, dtype=dtype, device=dev).view(d, 1, 1),
                torch.as_tensor(width_np, dtype=dtype, device=dev).view(d, 1, 1),
                torch.Generator(device=dev),
            )
    eps = torch.finfo(dtype).eps

    def draw(dev, stream: int, it: int, shard: int) -> torch.Tensor:
        if uniforms is not None:
            return torch.as_tensor(uniforms(it, shard), dtype=dtype, device=dev)
        gen = per_dev[dev][2]
        gen.manual_seed(stream_seed(stream, it, shard))
        return torch.rand((d, Ns), generator=gen, dtype=dtype, device=dev)

    def partials(r, state, edges, cum, theta):
        """Rank r's shards of every problem: (s1, s2, g) with a shard axis."""
        dev = ranks.devices[r]
        lo, width, _ = per_dev[dev]
        P = edges.shape[0]
        first = r * local
        n = local * Ns
        with _stage("vegas.sample_map"):
            u = torch.empty((d, P, n), dtype=dtype, device=dev)
            for p in range(P):
                for k in range(local):
                    u[:, p, k * Ns:(k + 1) * Ns] = draw(
                        dev, int(state.stream[p]), int(state.it[p]), first + k
                    )
            index = (first * Ns + torch.arange(n, device=dev)).expand(P, n).contiguous()
            y, _ = stratified.sample_y(u, cum, index, n_strat, d)
            del u, index
            x01, jac = grid_lib.apply_map(edges.transpose(0, 1), y)
            x = lo + width * x01
            del x01
        with _stage("vegas.integrand"):
            if has_theta:
                val = fn(x, theta)
            else:
                val = torch.stack([fn(x[:, p]) for p in range(P)])
            w = val.to(dtype) * jac * volume
            del x, val, jac
        with _stage("vegas.reduce"):
            return vegas_sums(w.contiguous(), y, cum, nb, first, Ns)

    def iterate(state: VegasState, theta=None):
        dev0 = ranks.first
        with _stage("vegas.refine"):
            counts = stratified.allocate_counts(state.strat_w, N, cfg.mc_min_per_cube)
            cum = torch.cumsum(counts, dim=-1)
        parts = []
        for r, dev in enumerate(ranks.devices):
            # the grid and counts go to every rank (a no-op on the first
            # rank's device); theta is the service pool's, single-rank
            parts.append(partials(
                r, state, state.edges.to(dev, non_blocking=True),
                cum.to(dev, non_blocking=True), theta,
            ))
        # gather in rank order == shard order, then the pinned combine
        with _stage("vegas.reduce"):
            s1, s2, g = (
                _ordered_sum(torch.cat([p[i].to(dev0, non_blocking=True) for p in parts], dim=1), 1)
                for i in range(3)
            )
        with _stage("vegas.refine"):
            return update(state, counts, s1, s2, g)

    def update(state, counts, s1, s2, g):
        """Quarantine, the iteration's estimate, grid and count refinement,
        and the weighted average, on the first rank."""
        dev0 = ranks.first
        P = state.edges.shape[0]

        # --- per-stratum non-finite quarantine -------------------------------
        # A NaN/Inf integrand value poisons its stratum's sums, and from there
        # the estimate, the accumulators and the grid.  Zero the poisoned
        # strata (and grid bins) and flag the iteration: the drivers stop
        # the problem with status "nonfinite".  Non-finite accumulators are
        # terminal too.  For finite integrands every mask is all-False and
        # every where() leaves the bits as they are.
        bad_k = ~(torch.isfinite(s1) & torch.isfinite(s2))
        bad_acc = ~(
            torch.isfinite(state.sum_wi) & torch.isfinite(state.sum_w)
            & torch.isfinite(state.sum_wi2)
        )
        nonfinite = torch.any(bad_k, dim=-1) | bad_acc
        zero = torch.zeros((), dtype=dtype, device=dev0)
        s1 = torch.where(bad_k, zero, s1)
        s2 = torch.where(bad_k, zero, s2)
        g = torch.where(torch.isfinite(g), g, zero)

        nk = counts.to(dtype)
        mean = s1 / nk
        i_t = torch.sum(mean, dim=-1) / M
        var_k = torch.clamp(s2 / nk - mean * mean, min=0.0)
        sig2_t = torch.sum(var_k / (nk - 1.0), dim=-1) / (M * M)
        # round-off floor: an exactly representable integrand (zero sample
        # variance) must not produce an infinite weight
        sig2_t = torch.maximum(sig2_t, (eps * (torch.abs(i_t) + 1e-30)) ** 2)

        # --- adapt -----------------------------------------------------------
        edges = grid_lib.refine(state.edges, g.reshape(P, d, nb), cfg.mc_alpha)
        strat_w = stratified.adapt_weights(state.strat_w, var_k, cfg.mc_beta)

        # --- accumulate the weighted-average estimator -----------------------
        # the counters are the host's: one small copy carries what the
        # device needs of them
        acc = state.it >= cfg.mc_warmup
        n_acc = state.n_acc + acc
        flags = to_device(
            np.stack([acc, n_acc > 0, n_acc > 1, np.maximum(n_acc - 1, 1)]), dtype, dev0
        )
        acc_t, have, multi, dof = flags[0] > 0, flags[1] > 0, flags[2] > 0, flags[3]
        inv = torch.where(acc_t, 1.0 / sig2_t, zero)
        sum_w = state.sum_w + inv
        sum_wi = state.sum_wi + i_t * inv
        sum_wi2 = state.sum_wi2 + i_t * i_t * inv

        safe_w = torch.where(have, sum_w, torch.ones_like(sum_w))
        integral = torch.where(have, sum_wi / safe_w, i_t)
        sigma = torch.where(have, torch.sqrt(1.0 / safe_w), torch.sqrt(sig2_t))
        chi2 = torch.clamp(sum_wi2 - sum_wi * sum_wi / safe_w, min=0.0)
        chi2_dof = torch.where(multi, chi2 / dof, zero)
        error = sigma * torch.sqrt(torch.clamp(chi2_dof, min=1.0))

        new_state = VegasState(
            edges=edges, strat_w=strat_w, sum_wi=sum_wi, sum_w=sum_w, sum_wi2=sum_wi2,
            stream=state.stream, it=state.it + 1, n_acc=n_acc,
            n_evals=state.n_evals + float(N),
        )
        metrics = {
            "integral": integral,
            "error": error,
            "chi2_dof": chi2_dof,
            "nonfinite": nonfinite,
            "it_integral": i_t,
            "it_sigma": torch.sqrt(sig2_t),
            "n_acc": n_acc,
        }
        return new_state, metrics

    return iterate


def read_metrics(metrics: dict) -> dict:
    """The host's one read of an iteration: ``_READ`` as float64 arrays (P,)."""
    host = torch.stack([metrics[k].double() for k in _READ]).cpu().numpy()
    return dict(zip(_READ, host))


def _theta_fn(family: ParamIntegrand, theta) -> Callable[[torch.Tensor], torch.Tensor]:
    """``family`` with ``theta`` bound, its leaves copied to each device once
    (a pageable copy per call would make the host wait for the device)."""
    cache = {}

    def fn(x: torch.Tensor) -> torch.Tensor:
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = {k: torch.as_tensor(np.asarray(v), dtype=x.dtype, device=x.device)
                          for k, v in theta.items()}
        return family.fn(x, cache[key])

    return fn


def resolve_fn(cfg: QuadratureConfig, integrand: Optional[Callable]) -> Callable:
    """Integrand of the single-problem drivers: an explicit callable wins,
    else the config-named registry entry or family spec."""
    if integrand is not None:
        return integrand
    if ":" in cfg.integrand:
        family, theta = parse_spec(cfg.integrand)
        return _theta_fn(family, theta)
    return get_integrand(cfg.integrand).fn


def converged_now(cfg: QuadratureConfig, integral: float, error: float, n_acc: int) -> bool:
    """The MC convergence predicate of the host loop (the pool applies the
    same test to every slot with the slot's own tolerances)."""
    budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
    return n_acc >= MIN_ACCUMULATED and error <= budget


def drive(
    cfg: QuadratureConfig,
    iterate: Callable,
    callback: Optional[Callable[[int, float, float, float], None]] = None,
    device="cuda",
) -> VegasResult:
    """The shared host loop: run ``iterate`` (any :func:`make_iterate`, one
    rank or several) to convergence or the iteration cap, one stacked read
    of (integral, error, chi^2/dof, nonfinite) per iteration."""
    state = init_state(cfg, device)
    integral = error = chi2 = 0.0
    converged = nonfinite = False
    syncs = 0
    for _ in range(cfg.mc_max_iters):
        state, m = iterate(state)
        got = read_metrics(m)
        syncs += 1
        integral, error, chi2 = (float(got[k][0]) for k in ("integral", "error", "chi2_dof"))
        if callback is not None:
            callback(int(state.it[0]), integral, error, chi2)
        if got["nonfinite"][0]:
            # poisoned strata were quarantined inside the iterate; the
            # combined estimate is best-effort, so stop rather than keep
            # averaging over a hole in the integrand
            nonfinite = True
            break
        if converged_now(cfg, integral, error, int(state.n_acc[0])):
            converged = True
            break
    status = "nonfinite" if nonfinite else "converged" if converged else "max_iters"
    return VegasResult(
        integral=integral,
        error=error,
        status=status,
        iterations=int(state.it[0]),
        n_evals=float(state.n_evals[0]),
        n_active=0,
        overflowed=False,
        host_syncs=syncs,
        chi2_dof=chi2,
    )


def integrate_vegas(
    cfg: QuadratureConfig,
    integrand: Optional[Callable] = None,
    callback: Optional[Callable[[int, float, float, float], None]] = None,
    device="cuda",
) -> VegasResult:
    """Host-driven VEGAS loop on one device, one host read per iteration.

    Convergence is the cubature drivers' budget, ``error <= max(abs_tol,
    |I| * rel_tol)``, on the weighted-average estimate with the
    chi^2-inflated error and at least ``MIN_ACCUMULATED`` accumulated
    iterations.  Runs on CUDA unless ``device="cpu"``.
    """
    cfg = cfg.validate()
    device = resolve_device(device)
    fn = resolve_fn(cfg, integrand)
    return drive(cfg, make_iterate(cfg, fn, devices=[device]), callback, device=device)


# --- the service pool: B independent VEGAS problems ------------------------


@dataclasses.dataclass
class VegasBatchState:
    """The pool: a :class:`VegasState` over every slot, masks on the host."""

    mc: VegasState  # P = batch_slots
    theta: torch.Tensor  # (n_theta, B), theta_fields order
    rel_tol: np.ndarray  # (B,) per-request tolerances
    abs_tol: np.ndarray  # (B,)
    occupied: np.ndarray  # (B,) bool
    done: np.ndarray  # (B,) bool
    admit_seq: np.ndarray  # (B,) int64 admissions seen per slot (keys the draws)


# the VegasState fields on the device and on the host, and the pool's host
# arrays (snapshot layout of VegasBatchEngine.to_host)
_MC_TENSORS = ("edges", "strat_w", "sum_wi", "sum_w", "sum_wi2")
_MC_COUNTERS = ("stream", "it", "n_acc", "n_evals")
_POOL_HOST = ("rel_tol", "abs_tol", "occupied", "done", "admit_seq")


def _family(cfg: QuadratureConfig, family) -> ParamIntegrand:
    if family is None:
        family = cfg.integrand.partition(":")[0]
    if isinstance(family, str):
        family = get_param(family)
    return family


class VegasBatchEngine:
    """MC twin of :class:`repro_torch.service.batch_engine.BatchEngine`.

    Drives ``cfg.batch_slots`` independent VEGAS problems of one integrand
    family with the slot protocol the scheduler speaks (``init`` / ``admit``
    / ``release`` / ``run`` / ``status_of``), so the continuous-batching
    service admits MC-backed requests through the same host loop.  Each
    iteration runs :func:`make_iterate`'s update once over the live slots
    (theta leaves ``(d, P, 1)`` broadcast against ``(d, P, N)``
    coordinates), and the host reads one stacked set of values for them.

    The pool is single-rank: MC parallelism lives at the sample level
    (:mod:`repro_torch.mc.multi_device` shards one problem's samples), not
    the slot level.  A slot's draws are keyed by ``(mc_seed, slot,
    admission number)``, so the same request stream gives the same bits.
    """

    backend = "vegas"
    n_ranks = 1

    def __init__(
        self,
        cfg: QuadratureConfig,
        family: Union[ParamIntegrand, str, None] = None,
        devices: Optional[Sequence] = None,
    ):
        cfg = cfg.validate()
        if (devices is not None and len(devices) > 1) or (
            devices is None and cfg.service_devices not in (0, 1)
        ):
            raise ValueError(
                "the vegas service pool is single-device (one rank drives every "
                "slot); MC multi-rank parallelism shards samples instead: see "
                "repro_torch.mc.multi_device.integrate_vegas_distributed"
            )
        self.cfg = cfg
        self.family = _family(cfg, family)
        self.device = rank_device(devices[0]) if devices is not None else cuda_devices(1)[0]
        self.n_slots = cfg.batch_slots
        self.slots_per_rank = self.n_slots
        self.theta_template = {
            k: np.zeros(np.shape(v), np.float64)
            for k, v in self.family.sample_theta(cfg.d, np.random.default_rng(0)).items()
        }
        self.n_theta = sum(v.size for v in self.theta_template.values())
        self._dtype = getattr(torch, cfg.dtype)
        self._fresh = init_state(cfg, self.device)
        self._iterate = make_iterate(cfg, self.family.fn, has_theta=True, devices=[self.device])

    # --- state ---------------------------------------------------------------

    def init(self) -> VegasBatchState:
        cfg, B = self.cfg, self.n_slots
        return VegasBatchState(
            mc=init_state(cfg, self.device, n=B),
            theta=torch.zeros((self.n_theta, B), dtype=self._dtype, device=self.device),
            rel_tol=np.full(B, cfg.rel_tol, np.float64),
            abs_tol=np.full(B, cfg.abs_tol, np.float64),
            occupied=np.zeros(B, bool),
            done=np.zeros(B, bool),
            admit_seq=np.zeros(B, np.int64),
        )

    def _check_slot(self, slot: int) -> None:
        if not 0 <= int(slot) < self.n_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.n_slots})")

    def admit(
        self,
        state: VegasBatchState,
        slot: int,
        theta,
        rel_tol: Optional[float] = None,
        abs_tol: Optional[float] = None,
    ) -> VegasBatchState:
        """A fresh grid, counts and estimator in ``slot``, with its theta."""
        self._check_slot(slot)
        got = {k: np.shape(v) for k, v in theta.items()}
        want = {k: v.shape for k, v in self.theta_template.items()}
        if got != want:
            raise ValueError(
                f"theta shape mismatch for family {self.family.name!r}: "
                f"got {got}, want {want}"
            )
        mc, fresh = state.mc, self._fresh
        seq = int(state.admit_seq[slot]) + 1
        for k in _MC_TENSORS:
            getattr(mc, k)[slot] = getattr(fresh, k)[0]
        mc.stream[slot] = stream_seed(self.cfg.mc_seed, slot, seq)
        mc.it[slot] = mc.n_acc[slot] = 0
        mc.n_evals[slot] = 0.0
        host = np.concatenate(
            [np.asarray(theta[k], np.float64).reshape(-1) for k in self.family.theta_fields]
        )
        state.theta[:, slot] = to_device(host, self._dtype, self.device)
        state.rel_tol[slot] = self.cfg.rel_tol if rel_tol is None else rel_tol
        state.abs_tol[slot] = self.cfg.abs_tol if abs_tol is None else abs_tol
        state.occupied[slot] = True
        state.done[slot] = False
        state.admit_seq[slot] = seq
        return state

    def release(self, state: VegasBatchState, slot: int) -> VegasBatchState:
        self._check_slot(slot)
        state.occupied[slot] = False
        state.done[slot] = False
        return state

    # --- the pool on the host (snapshots) ------------------------------------

    def host_shapes(self) -> dict[str, tuple]:
        """Name -> shape of every array of :meth:`to_host`."""
        B, d = self.n_slots, self.cfg.d
        shapes = {f"mc/{k}": (B,) for k in _MC_TENSORS + _MC_COUNTERS}
        shapes["mc/edges"] = (B, d, self.cfg.mc_bins + 1)
        shapes["mc/strat_w"] = (B, mc_layout(self.cfg)[1])
        shapes["theta"] = (B, self.n_theta)
        shapes.update({k: (B,) for k in _POOL_HOST})
        return shapes

    def to_host(self, state: VegasBatchState) -> dict[str, np.ndarray]:
        """The pool as slot-major host arrays with a leading ``B`` axis:
        every field of the :class:`VegasState` as ``mc/<field>``, ``theta``
        as ``(B, n_theta)``, the tolerances, the masks and ``admit_seq``
        (it keys the draws: without it a resumed slot would draw other
        samples).  Every array is a copy (see :meth:`BatchEngine.to_host`)."""
        host = {f"mc/{k}": getattr(state.mc, k).to("cpu", copy=True).numpy()
                for k in _MC_TENSORS}
        host.update({f"mc/{k}": getattr(state.mc, k).copy() for k in _MC_COUNTERS})
        host["theta"] = state.theta.T.to("cpu", copy=True).numpy()
        host.update({k: getattr(state, k).copy() for k in _POOL_HOST})
        return host

    def place(self, host) -> VegasBatchState:
        """The pool from :meth:`to_host`'s arrays, on this engine's device
        (copies, as :meth:`BatchEngine.place`)."""
        for k, shape in self.host_shapes().items():
            if tuple(np.shape(host[k])) != shape:
                raise ValueError(f"{k}: shape {np.shape(host[k])} != {shape}")
        mc = VegasState(
            **{k: copy_to(host[f"mc/{k}"], self.device) for k in _MC_TENSORS},
            **{k: np.array(host[f"mc/{k}"]) for k in _MC_COUNTERS},
        )
        return VegasBatchState(
            mc=mc, theta=copy_to(host["theta"].T, self.device),
            **{k: np.array(host[k]) for k in _POOL_HOST},
        )

    # --- one iteration -------------------------------------------------------

    def _iterate_live(self, state: VegasBatchState):
        """One iteration of every live slot; returns the per-slot row (the
        JAX engine's metrics: values of the live slots, zeros elsewhere)
        and the number of slots that finished."""
        cfg, B, mc = self.cfg, self.n_slots, state.mc
        row = {k: np.zeros(B, np.float64) for k in ("integral", "error", "n_evals")}
        row.update({k: np.zeros(B, np.int64) for k in ("n_active", "it")})
        row.update({k: np.zeros(B, bool) for k in ("overflowed", "converged", "nonfinite")})
        row["occupied"] = state.occupied.copy()
        live = np.flatnonzero(state.occupied & ~state.done)
        if not len(live):
            row["done"] = state.done.copy()
            return row, 0
        idx = slice(None) if len(live) == B else to_device(live, torch.long, self.device)
        sub = VegasState(
            edges=mc.edges[idx], strat_w=mc.strat_w[idx], sum_wi=mc.sum_wi[idx],
            sum_w=mc.sum_w[idx], sum_wi2=mc.sum_wi2[idx], stream=mc.stream[live],
            it=mc.it[live], n_acc=mc.n_acc[live], n_evals=mc.n_evals[live],
        )
        cols = state.theta[:, idx]
        theta, at = {}, 0
        for k in self.family.theta_fields:
            size = self.theta_template[k].size
            theta[k] = cols[at:at + size, :, None]
            at += size
        new, m = self._iterate(sub, theta)
        for k in _MC_TENSORS:
            getattr(mc, k)[idx] = getattr(new, k)
        mc.it[live], mc.n_acc[live], mc.n_evals[live] = new.it, new.n_acc, new.n_evals
        got = read_metrics(m)
        budget = np.maximum(state.abs_tol[live], np.abs(got["integral"]) * state.rel_tol[live])
        converged = (got["error"] <= budget) & (new.n_acc >= MIN_ACCUMULATED)
        capped = new.it >= cfg.mc_max_iters
        nonfinite = got["nonfinite"] > 0
        terminal = converged | capped | nonfinite
        state.done[live] = terminal
        for k, v in (
            ("integral", got["integral"]), ("error", got["error"]), ("n_evals", new.n_evals),
            ("it", new.it), ("converged", converged), ("nonfinite", nonfinite),
        ):
            row[k][live] = v
        row["done"] = state.done.copy()
        return row, int(terminal.sum())

    def run(self, state: VegasBatchState, max_steps: int, tick: int):
        """Same contract as :meth:`BatchEngine.run` (``moved`` has no rows):
        up to ``min(max_steps, cfg.sync_every)`` iterations, stopping after
        the first in which a slot finishes."""
        K = self.cfg.sync_every
        steps = min(int(max_steps), K)
        if steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        executed = np.zeros(K, bool)
        rows = []
        for t in range(steps):
            row, n_new = self._iterate_live(state)
            rows.append({**row, "window": np.zeros(1, np.int64)})
            executed[t] = True
            if n_new:
                break
        metrics = {
            k: np.stack([r[k] for r in rows] + [np.zeros_like(rows[0][k])] * (K - len(rows)))
            for k in rows[0]
        }
        return state, metrics, executed, np.full((K, 0, 2), -1, np.int64)

    def status_of(
        self,
        converged: bool,
        n_active: int,
        it: int,
        overflowed: bool,
        nonfinite: bool = False,
    ) -> str:
        """MC terminal taxonomy: no region store, so no capacity/no_active."""
        if nonfinite:
            return "nonfinite"
        if converged:
            return "converged"
        if it >= self.cfg.mc_max_iters:
            return "max_iters"
        return "running"
