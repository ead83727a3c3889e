"""Tier-1 test configuration.

Pin JAX to the CPU backend before any test module imports jax: the CI
image (and some dev containers) carry libtpu without a TPU, and an
unpinned import stalls ~60 s probing for one.  Pinning here makes tier-1
deterministic and fast everywhere, not only in ``benchmarks/*`` entry
points (which set the same guard themselves).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skips without one.  On the card: python -m pytest -m "
        "cuda tests/test_torch_backward_cuda.py")
