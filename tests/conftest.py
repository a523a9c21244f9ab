"""Test harness config: the suite runs on the CPU backend with 8 virtual
devices so the sharding tests work without a GPU (SURVEY.md §4: the suite
must be CPU-runnable, the triangle demo is the e2e smoke test).  Pallas
kernels run in interpret mode there.

JAX_PLATFORMS, when set, wins: tests marked `gpu` compile the kernels for the
card and run only where JAX sees one, e.g.

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
# Keep f32 math f32 on any backend (no reduced-precision f32 matmuls).
jax.config.update("jax_default_matmul_precision", "highest")

import pytest  # noqa: E402

# Two test tiers: the default run skips the multi-minute
# compile-heavy tests (reference-GI scale golden, per-pass toggle goldens,
# the big sharded-parity frames, the end-to-end preview session) so a
# per-change `pytest tests/ -q` stays fast; RUN_SLOW=1 (CI / pre-commit of
# GI or sharding changes) runs everything.  The slow tier is documented in
# CLAUDE.md; the fast-GI golden and one sharded-parity test stay
# default-on as the precision/parity safety net.
RUN_SLOW = os.environ.get("RUN_SLOW") == "1"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute compile-heavy tier; run with RUN_SLOW=1"
    )
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips elsewhere"
    )


def pytest_collection_modifyitems(config, items):
    if RUN_SLOW:
        return
    skip = pytest.mark.skip(reason="slow tier: set RUN_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none (decided
    here, at run time, so every worker collects the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu pytest -m gpu")
    return devs[0]
