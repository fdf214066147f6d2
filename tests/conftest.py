import jax

# The quadrature stack targets float64 accuracy experiments (the paper runs
# down to tau_rel = 1e-12); LM-substrate code always passes explicit dtypes,
# so enabling x64 here does not affect those tests.
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one; run on the GPU machine)"
    )
