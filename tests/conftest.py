"""Test configuration: run everything on a virtual 8-device CPU mesh.

Correctness tests run on the CPU backend (fast compiles, f32
determinism) with 8 virtual devices so the sharded/halo-exchange paths
are exercised without several cards, mirroring the reference's trust in
``apply_parallel`` tiling (SURVEY.md §4).  The Pallas kernel runs there
in interpret mode.

Tests marked ``gpu`` need the card: they skip on the CPU (the ``gpu``
fixture decides, at run time) and run with
``NEILPY_TEST_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

# Long suite runs (hundreds of XLA CPU compiles in one process) have
# segfaulted inside LLVM during a deep _smrf_exact f64 compile with the
# default 8 MB main-thread stack; the same tests pass in a fresh
# process.  Raise the stack soft limit to the hard limit (unlimited
# here) so recursive compiler passes can't blow the main stack.
try:
    import resource
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    if _soft != resource.RLIM_INFINITY and (_hard == resource.RLIM_INFINITY
                                            or _hard > _soft):
        resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except Exception:  # platform without RLIMIT_STACK semantics
    pass

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") +
     " --xla_force_host_platform_device_count=8").strip())

import jax

# CPU unless the card tests ask for it; config.update wins over any
# JAX_PLATFORMS already in the environment
jax.config.update("jax_platforms",
                  os.environ.get("NEILPY_TEST_PLATFORMS", "cpu"))

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The GPU device, or skip: presence is decided here, at run time,
    never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform}); run "
                    "with NEILPY_TEST_PLATFORMS=cuda -m gpu on the card")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def terrain(rng):
    """A smooth-ish random terrain with relief, float64 host-side."""
    Z = rng.normal(size=(48, 56)).cumsum(axis=0).cumsum(axis=1)
    return Z


ISPRS_DIR = "/root/reference/sample_data"


def isprs_path(name):
    return os.path.join(ISPRS_DIR, name)
