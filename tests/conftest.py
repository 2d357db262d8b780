import os

# Tests run single-device (the dry-run, and ONLY the dry-run, uses 512
# placeholder devices via its own entry point).  Multi-device tests spawn
# subprocesses with their own XLA_FLAGS (see test_multidevice.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (subprocess / multidevice)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")
