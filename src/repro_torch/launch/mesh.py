"""Production mesh construction: the port of :mod:`repro.launch.mesh`.

Defined as FUNCTIONS (not module-level constants), so that importing this
module touches no process group.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the default process group, which must have as
    many ranks as the mesh.  Single pod: (data=16, model=16), 256 ranks.
    Multi-pod: (pod=2, data=16, model=16), 512 ranks; the "pod" axis is pure
    data parallelism.  The dry run builds it over a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_quadrature_mesh(n_devices: int | None = None):
    """The devices of the distributed quadrature engine's ranks: rank r on
    cuda:(r mod device count), one rank per visible card by default.  The
    port's ranks are driven by one host process
    (:mod:`repro_torch.core.ranks`), not a process group."""
    import torch

    from repro_torch.core.ranks import cuda_devices

    return cuda_devices(torch.cuda.device_count() if n_devices is None else n_devices)
