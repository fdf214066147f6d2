"""Configuration for the adaptive quadrature engine (single- and multi-device).

Same fields, defaults and ``validate()`` rules as the JAX package's
``QuadratureConfig``, without its two Pallas-only fields (``use_kernel``,
``interpret``).  Fields of later slices (VEGAS, batch service, distributed)
are kept so that configs carry across unchanged.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuadratureConfig:
    """Static configuration of one integration problem.

    Everything here is compile-time static; the dynamic problem state lives in
    :class:`repro_torch.core.region_store.RegionState`.
    """

    d: int
    integrand: str = "f4"
    rel_tol: float = 1e-8
    abs_tol: float = 1e-16  # the paper's floor: eps <= max(1e-16, |I| tau_rel)
    # --- backend selection ----------------------------------------------------
    # "cubature" runs the deterministic adaptive-subdivision engine (the
    # paper's reproduction); "vegas" runs the adaptive importance-sampling
    # Monte Carlo subsystem (repro.mc) whose cost is dimension-independent
    # per sample — the only feasible regime once the Genz-Malik point count
    # (2^d + 2d^2 + 2d + 1 per region) explodes; "auto" picks vegas at
    # d >= auto_backend_dim and cubature below it.
    backend: str = "cubature"  # "cubature" | "vegas" | "auto"
    auto_backend_dim: int = 9  # "auto" crossover dimension (see DESIGN.md §7)
    capacity: int = 1 << 14  # fixed SoA region-store capacity per device
    # Initial uniform partition size (power of two).  0 = auto: 2^d clipped to
    # capacity/4 — splitting EVERY axis at least once is required so that a
    # sharp feature at the domain centre (e.g. f4's Gaussian, which sits on
    # the corner of every octant) is bracketed by rule nodes; with fewer
    # boxes the fully-symmetric rule can be structurally blind to it and
    # converge to a wrong answer (regression-tested).
    n_init: int = 0
    max_iters: int = 600
    classifier: str = "robust"  # "robust" (ours) | "aggressive" (PAGANI-like)
    rule: str = "genz_malik"  # "genz_malik" | "gauss_kronrod"
    # Threads per CUDA block of the GM kernel; 0 = the kernel wrapper default.  The
    # device decides the path: CUDA tensors go through the kernel, CPU
    # tensors through its plain PyTorch version.
    block_regions: int = 0
    dtype: str = "float64"
    # --- active-window evaluation --------------------------------------------
    # The compaction invariant (see region_store / split docstrings) keeps all
    # active regions contiguous at the front of the store, so the rule only
    # needs to be evaluated on the leading window of the SoA arrays.  Window
    # sizes are drawn from a geometric ladder of powers of two so the number
    # of distinct compiled shapes stays at log2(capacity / eval_window_min).
    eval_window: bool = True  # evaluate only the leading active window
    eval_window_min: int = 256  # smallest ladder bucket (power of two)
    # Window the *advance* stage too (classify thresholding, global-estimate
    # reductions, and the sort-based split/compact): the argsort and every
    # gather/scatter run on the smallest ladder rung covering
    # min(2 * n_active, capacity) — splitting can double the population, and
    # the capacity-pressure scalars (the 3C/4 forced-finalise limit, the
    # split budget k = min(n_act, C - n_act)) stay defined against the full
    # capacity, so trajectories are bit-identical to the full-capacity
    # advance in every regime (see DESIGN.md §3).  Shares eval_window_min as
    # the smallest rung.
    advance_window: bool = True
    # --- batch service -------------------------------------------------------
    # The continuous-batching engine (repro.service) runs ``batch_slots``
    # independent problems of this config's shape in lockstep under vmap; a
    # slot freed by a converged problem is refilled from the request queue
    # every ``admit_every`` iterations.
    batch_slots: int = 16
    admit_every: int = 1
    # An overflowed slot may keep refining this many further iterations
    # before the scheduler evicts it with status "capacity".  The serial
    # driver grinds past capacity pressure and often still converges
    # (children that don't fit are dropped, the survivors keep shrinking
    # the error), so evicting at *first* overflow would both break parity
    # with `integrate` and throw away near-finished work; the grace period
    # keeps parity for transiently-saturated problems while still freeing
    # the slot from hopeless ones long before max_iters.
    evict_patience: int = 16
    # --- sharded service mesh + problem-level rebalancing ---------------------
    # The batch service shards its leading problem axis over a device mesh:
    # each device owns a contiguous block of batch_slots / n_devices slots and
    # runs the vmapped windowed step locally.  ``service_devices`` picks the
    # mesh size (1 = single-device legacy path, 0 = every visible device);
    # an explicit mesh/devices argument to BatchEngine overrides it.
    service_devices: int = 1
    # When a device's live slots drain (converged problems collected, queue
    # dry), whole *problems* migrate from its cyclic ring partner — the same
    # static-schedule ppermute pairing ``redistribution.redistribute`` uses
    # for regions, lifted to the problem level.  "off" disables migration;
    # ``rebalance_cap`` bounds problems moved per pair per iteration (the
    # payload is a full slot: region store + theta + tolerances).
    rebalance: str = "ring"
    rebalance_cap: int = 1
    # --- distributed ---------------------------------------------------------
    message_cap: int = 512  # max regions per transfer (paper default)
    init_regions_per_device: int = 8  # paper: 8 subdomains per rank at startup
    redistribution: str = "ring"  # any value != "off" enables the static
    #   ring-schedule round-robin policy ("xor" accepted as a legacy alias)
    sync_every: int = 4  # iterations per dispatch in integrate_device and
    #   integrate_distributed: the host reads the per-iteration snapshots once
    #   per dispatch and keeps the iterations up to the first that converged
    # --- numerical guards (Gander-Gautschi style) -----------------------------
    min_width_frac: float = 1e-10  # halfwidth floor relative to domain width
    noise_mult: float = 50.0  # round-off noise floor multiplier
    # A region may not be FINALISED before it has been bisected this many
    # times per axis (on average, by volume): pre-asymptotic rule estimates
    # on smooth peaked integrands (f3) can coincidentally agree while all
    # biased the same way, so the summed claimed error understates the true
    # error ~10x at loose tolerances; two confirmed halvings per axis puts
    # the embedded differences in the asymptotic regime first.  Convergence
    # itself needs no finalisation, so cheap problems are unaffected.
    min_depth_per_axis: int = 2
    # --- VEGAS backend (repro.mc) ---------------------------------------------
    # One MC iteration draws ``mc_samples`` stratified samples through the
    # per-axis importance grid (``mc_bins`` bins per axis), accumulates
    # per-stratum mean/variance, and refines grid + per-stratum sample
    # counts.  The sample stream is generated and reduced in ``mc_shards``
    # fixed independent shards — the unit of multi-device work division —
    # so estimates are bit-identical at any device count dividing it.
    mc_samples: int = 8192  # samples per iteration (divisible by mc_shards)
    mc_bins: int = 64  # importance-grid bins per axis
    mc_shards: int = 8  # static reduction shards (>= and divisible by devices)
    mc_warmup: int = 5  # adapt-only iterations excluded from the estimator
    mc_max_iters: int = 100  # MC iteration cap (cubature keeps max_iters)
    mc_alpha: float = 0.75  # grid-refinement damping exponent (Lepage alpha)
    mc_beta: float = 0.75  # stratification count-adaptation exponent (VEGAS+)
    mc_min_per_cube: int = 4  # floor on samples per stratification hypercube
    mc_seed: int = 0  # PRNG seed: same seed -> bit-identical estimate
    # --- domain (defaults to the unit cube) -----------------------------------
    domain_lo: tuple = ()
    domain_hi: tuple = ()

    def lo(self) -> tuple:
        return self.domain_lo if self.domain_lo else (0.0,) * self.d

    def hi(self) -> tuple:
        return self.domain_hi if self.domain_hi else (1.0,) * self.d

    def resolved_backend(self) -> str:
        """Concrete backend for this problem ("auto" resolves on dimension)."""
        if self.backend == "auto":
            return "vegas" if self.d >= self.auto_backend_dim else "cubature"
        return self.backend

    def resolved_n_init(self) -> int:
        if self.n_init:
            return self.n_init
        return max(8, min(2**self.d, self.capacity // 4, 1 << 12))

    def validate(self) -> "QuadratureConfig":
        if self.d < 1:
            raise ValueError("d must be >= 1")
        if self.capacity & (self.capacity - 1):
            raise ValueError("capacity must be a power of two")
        if self.n_init & (self.n_init - 1):
            raise ValueError("n_init must be a power of two (or 0 = auto)")
        if self.resolved_n_init() > self.capacity // 2:
            raise ValueError("n_init must leave room to split (<= capacity/2)")
        if self.classifier not in ("robust", "aggressive"):
            raise ValueError(f"unknown classifier {self.classifier!r}")
        if self.rule not in ("genz_malik", "gauss_kronrod"):
            raise ValueError(f"unknown rule {self.rule!r}")
        if self.eval_window_min < 1 or (
            self.eval_window_min & (self.eval_window_min - 1)
        ):
            raise ValueError("eval_window_min must be a positive power of two")
        if self.block_regions < 0 or (
            self.block_regions & (self.block_regions - 1)
        ):
            raise ValueError("block_regions must be a power of two (or 0 = default)")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.admit_every < 1:
            raise ValueError("admit_every must be >= 1")
        if self.evict_patience < 0:
            raise ValueError("evict_patience must be >= 0")
        if self.service_devices < 0:
            raise ValueError("service_devices must be >= 0 (0 = all devices)")
        if self.rebalance not in ("ring", "off"):
            raise ValueError(f"unknown rebalance policy {self.rebalance!r}")
        if self.rebalance_cap < 1:
            raise ValueError("rebalance_cap must be >= 1")
        if self.backend not in ("cubature", "vegas", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.auto_backend_dim < 1:
            raise ValueError("auto_backend_dim must be >= 1")
        if self.mc_shards < 1:
            raise ValueError("mc_shards must be >= 1")
        if self.mc_samples < 16 or self.mc_samples % self.mc_shards:
            raise ValueError(
                "mc_samples must be >= 16 and divisible by mc_shards "
                f"(got mc_samples={self.mc_samples}, mc_shards={self.mc_shards})"
            )
        if self.mc_bins < 2:
            raise ValueError("mc_bins must be >= 2")
        if self.mc_warmup < 1:
            raise ValueError("mc_warmup must be >= 1 (the estimator needs an "
                             "adapted grid before accumulating)")
        if self.mc_max_iters <= self.mc_warmup:
            raise ValueError("mc_max_iters must exceed mc_warmup")
        if self.mc_min_per_cube < 2:
            raise ValueError("mc_min_per_cube must be >= 2 (per-stratum "
                             "variance needs two samples)")
        if self.mc_samples < 2 * self.mc_min_per_cube:
            raise ValueError("mc_samples must cover 2 * mc_min_per_cube")
        if self.mc_alpha < 0 or self.mc_beta < 0:
            raise ValueError("mc_alpha / mc_beta must be >= 0")
        if len(self.domain_lo) not in (0, self.d):
            raise ValueError("domain_lo must be empty or length d")
        if len(self.domain_hi) not in (0, self.d):
            raise ValueError("domain_hi must be empty or length d")
        return self
