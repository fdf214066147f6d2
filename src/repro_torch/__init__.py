"""PyTorch/CUDA port of the adaptive quadrature engine.

:mod:`repro` (the JAX package, which stays the reference) rebuilt on
PyTorch, with its Pallas rule evaluation as a hand-written CUDA kernel for
Hopper (``kernels/csrc``):

- :mod:`repro_torch.core`: the paper's batch-adaptive cubature with the
  Genz-Malik and Gauss-Kronrod rules: ``integrate``, the device-resident
  ``integrate_device``, and the multi-rank ``integrate_distributed`` with
  the cyclic redistribution;
- :mod:`repro_torch.mc`: the VEGAS+ Monte Carlo backend, on one rank or
  with its sample shards over several;
- :mod:`repro_torch.service`: the batch quadrature service (continuous
  batching of fleets of integrals over ranks, either rule, a VEGAS pool,
  graceful re-routing, snapshots and resume, rank loss and regrowth);
- :mod:`repro_torch.telemetry`: the recorder, its sinks, Chrome traces,
  load views and the artifact checker, threaded through every driver;
- :mod:`repro_torch.launch`: the ``integrate`` and ``serve_quad`` CLIs and
  the card's measurement script ``gm_perf``.

Entry points run on the CUDA device unless the caller asks for
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""
