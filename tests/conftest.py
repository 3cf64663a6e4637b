"""Test configuration.

Device-kernel parity and sharding tests run on a virtual 8-device CPU mesh
so they exercise the same sharded programs a multi-GPU host runs,
deterministically and without requiring hardware; Pallas kernels run in
interpret mode there. Set ATROPOS_TPU_TEST_REAL_DEVICE=1 to run on
whatever real accelerator is attached instead — tests marked ``gpu``
(compiled kernels) run only then, on a GPU, and skip elsewhere:

    ATROPOS_TPU_TEST_REAL_DEVICE=1 python -m pytest -m gpu tests/

Forcing the platform through jax.config as well as JAX_PLATFORMS is
authoritative even when jax was imported before this file ran.
"""
import os

if not os.environ.get("ATROPOS_TPU_TEST_REAL_DEVICE"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
    except ImportError:
        pass

import pytest

# Golden-suite modules that run byte-exactness cases through the full trim
# command: every case runs twice, once with the scalar pipeline forced and
# once with the batched device engine forced, so engine conformance is
# proven on the ENTIRE behavioral surface (not a sampled subset).
_ENGINE_PARAMETRIZED_MODULES = ("test_trim_se", "test_trim_pe")


def pytest_generate_tests(metafunc):
    module = metafunc.module.__name__.rsplit(".", 1)[-1]
    if (
        module in _ENGINE_PARAMETRIZED_MODULES
        and "engine_mode" in metafunc.fixturenames
    ):
        metafunc.parametrize(
            "engine_mode", ["scalar", "engine"], indirect=True
        )


def pytest_terminal_summary(terminalreporter):
    """Report the batched-vs-scalar split of the engine-forced golden runs
    so coverage regressions are visible in the test log, and list every
    skipped test with its reason (skips must be loud: each one is an
    optional-dependency surface the suite did NOT exercise)."""
    from .conformance_utils import ENGINE_RUN_TALLY

    total = sum(ENGINE_RUN_TALLY.values())
    if total:
        terminalreporter.write_line(
            "engine-forced golden runs: {turbo} turbo, {engine} engine, "
            "{whitelisted_fallback} whitelisted-scalar (of {total})".format(
                total=total, **ENGINE_RUN_TALLY
            )
        )
    skipped = terminalreporter.stats.get("skipped", ())
    for report in skipped:
        reason = report.longrepr[2] if report.longrepr else ""
        terminalreporter.write_line(
            "skipped: {} ({})".format(report.nodeid, reason)
        )


@pytest.fixture(autouse=True)
def gpu_only(request):
    """Skip tests marked ``gpu`` unless JAX's default device is a GPU.
    Decided here, at run time, never while modules import, so every
    xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX backend is %s)"
                        % jax.default_backend())


@pytest.fixture(autouse=True)
def engine_mode(request, monkeypatch):
    """Force the trim pipeline mode for parametrized golden tests.

    Unparametrized tests leave the environment alone (engine defaults on).
    """
    mode = getattr(request, "param", None)
    if mode == "scalar":
        monkeypatch.setenv("ATROPOS_TPU_ENGINE", "0")
    elif mode == "engine":
        monkeypatch.setenv("ATROPOS_TPU_ENGINE", "1")
    return mode
