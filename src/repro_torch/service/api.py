"""Entry points of the batch quadrature service (the port of the JAX
package's ``repro.service.api``).

Two shapes of the same engine:

- :func:`integrate_batch`, the offline form: a fleet of thetas in, the list
  of results back in submission order (the batched analogue of calling
  :func:`repro_torch.core.adaptive.integrate` in a loop);
- :func:`serve`, the online form: any iterable (or generator) of
  :class:`QuadRequest`\\ s in, :class:`QuadResult`\\ s out as they converge.
  Requests are pulled lazily, so an unbounded stream backpressures on slot
  availability.

Both run on the visible GPUs unless ``devices`` says otherwise (e.g.
``devices=["cpu"]``; one entry per rank).  ``backend="vegas"`` (or
``"auto"`` at high d) serves through the single-rank VEGAS pool, and
``serve(graceful=True)`` through :class:`~repro_torch.service.routing.GracefulScheduler`.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand
from repro_torch.service.routing import GracefulScheduler
from repro_torch.service.scheduler import BatchScheduler, QuadRequest, QuadResult


def _as_theta_list(thetas: Union[Sequence[Any], Any]) -> list[Any]:
    """Normalise ``thetas`` to a list of per-problem dicts.

    Accepts a sequence of theta dicts (one per problem) or a single
    *stacked* dict whose leaves carry a leading batch axis.
    """
    if isinstance(thetas, dict):
        leaves = {k: np.asarray(v) for k, v in thetas.items()}
        sizes = {v.shape[0] for v in leaves.values()}
        if len(sizes) != 1:
            raise ValueError(
                "stacked theta leaves disagree on batch size: "
                f"{ {k: v.shape for k, v in leaves.items()} }"
            )
        (b,) = sizes
        return [{k: v[i] for k, v in leaves.items()} for i in range(b)]
    return list(thetas)


def serve(
    cfg: QuadratureConfig,
    requests: Iterable[QuadRequest],
    family: Union[ParamIntegrand, str, None] = None,
    devices: Optional[Sequence] = None,
    graceful: bool = False,
    resume: bool = False,
    **scheduler_kwargs,
) -> Iterator[QuadResult]:
    """Stream results for an arbitrary request iterable (convergence order).

    Extra keyword arguments (``checkpointer``, ``checkpoint_every``,
    ``on_tick``, ``fault_injector``, ``max_dispatch_retries``,
    ``dispatch_timeout_s``, ``retry_backoff_s``, and ``policy`` with
    ``graceful``) pass through to the scheduler.  ``graceful`` serves
    through :class:`GracefulScheduler`: ``capacity`` / ``nonfinite``
    cubature evictions are re-routed once to a VEGAS pool, ``max_iters``
    requests retried at a loosened tolerance.  ``resume=True`` restores the
    newest service snapshot before serving (it needs a ``checkpointer``).
    """
    cls = GracefulScheduler if graceful else BatchScheduler
    return cls(cfg, family, devices=devices, **scheduler_kwargs).serve(requests, resume=resume)


def integrate_batch(
    cfg: QuadratureConfig,
    thetas: Union[Sequence[Any], Any],
    family: Union[ParamIntegrand, str, None] = None,
    rel_tol: Union[float, Sequence[float], None] = None,
    abs_tol: Union[float, Sequence[float], None] = None,
    devices: Optional[Sequence] = None,
) -> list[QuadResult]:
    """Integrate a fleet of problems; results in submission order.

    ``thetas`` is a list of theta dicts (or one stacked dict with a leading
    batch axis); ``rel_tol`` / ``abs_tol`` are scalars applied to every
    problem, per-problem sequences, or ``None`` for the ``cfg`` defaults.
    ``family`` defaults to the family named by ``cfg.integrand``.  The
    results are the same at every rank count.
    """
    theta_list = _as_theta_list(thetas)
    n = len(theta_list)

    def per_problem(tol, name) -> list[Optional[float]]:
        if tol is None or np.ndim(tol) == 0:
            return [None if tol is None else float(tol)] * n
        if len(tol) != n:
            raise ValueError(f"{name} has {len(tol)} entries for {n} problems")
        return [float(t) for t in tol]

    rels = per_problem(rel_tol, "rel_tol")
    abss = per_problem(abs_tol, "abs_tol")
    requests = [
        QuadRequest(req_id=i, theta=t, rel_tol=r, abs_tol=a)
        for i, (t, r, a) in enumerate(zip(theta_list, rels, abss))
    ]
    results: list[Optional[QuadResult]] = [None] * n
    for res in serve(cfg, requests, family, devices=devices):
        results[res.req_id] = res
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:  # pragma: no cover - invariant guard
        raise RuntimeError(f"scheduler dropped requests {missing}")
    return results
