"""Test configuration: run everything on CPU with 8 virtual devices so the
mesh/shard_map paths are exercised without accelerator hardware (SURVEY.md
§4.3), and enable x64 so float64 golden-model comparisons are meaningful.

Tests marked ``gpu`` need the card and skip on the CPU. On a machine with
an NVIDIA GPU, ``CYTV_TEST_GPU=1 python -m pytest tests/test_gpu_step.py
-m gpu`` leaves JAX on its default (GPU) platform and runs them there.
"""

import os

_ON_CARD = os.environ.get("CYTV_TEST_GPU") == "1"
if not _ON_CARD:
    # tests run on the virtual CPU mesh even where an accelerator is
    # present, so override both the env var and the live config
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_card(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    if request.node.get_closest_marker("gpu") is not None \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with CYTV_TEST_GPU=1 on the "
                    "card)")


@pytest.fixture(autouse=True, scope="module")
def _bounded_compile_cache():
    """Drop JAX's executable caches between test modules.

    XLA:CPU's in-process compiler state grows over the suite's hundreds
    of distinct programs and has segfaulted (inside
    ``backend_compile_and_load``, only when a long suite ran first — the
    same compile passes in a fresh process). Clearing between modules
    keeps the compiler's working set bounded; per-module recompiles are
    cheap on CPU."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute tests (subprocess fan-out etc.)")
    config.addinivalue_line(
        "markers", "gpu: runs on the NVIDIA GPU; skips elsewhere")


def pytest_collection_modifyitems(config, items):
    """Quick-tier support: `pytest -m "not slow"` runs in <10 min.

    Slowness is data-driven from `.slow_durations.json` — a committed
    snapshot of per-test call durations (tests ≥8 s on the 8-device
    virtual CPU mesh, from a full `--durations=0` run; regenerate the
    same way after large suite changes). Tests absent from the snapshot
    (including new ones) default to the quick tier, so the full suite
    (`pytest tests/ -q`, the driver's gate) remains the source of truth
    and the quick tier is the developer inner loop.
    """
    import json

    path = os.path.join(os.path.dirname(__file__), ".slow_durations.json")
    try:
        with open(path) as f:
            slow_ids = set(json.load(f))
    except OSError:
        return
    for item in items:
        nodeid = item.nodeid.replace(os.sep, "/")
        if not nodeid.startswith("tests/"):
            nodeid = "tests/" + nodeid
        if nodeid in slow_ids:
            item.add_marker(pytest.mark.slow)
