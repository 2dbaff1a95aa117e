"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count); speed is measured on the GPU by
chip_smoke.py and bench.py, not in the test suite.  float64 makes
finite-difference gradient checks meaningful (note: this JAX build
evaluates transcendentals with float32-level accuracy even under x64, so
transcendental-path tolerances are ~1e-6).

JAX_PLATFORMS defaults to cpu.  Tests marked `gpu` need a GPU and skip
without one; run them on the card with
    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests when JAX has no GPU.  Decided here, per
    test, never while a module is imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs a GPU (run on the card with -m gpu)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def fd_grad(f, x, eps=1e-5):
    """Central-difference gradient of scalar f at x (same spirit as the
    reference's central_difference_deriviative checker,
    src/deriv_engine.cpp:291-342)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat = x.ravel()
    gflat = g.ravel()
    for i in range(flat.size):
        xp = flat.copy(); xp[i] += eps
        xm = flat.copy(); xm[i] -= eps
        gflat[i] = (f(xp.reshape(x.shape)) - f(xm.reshape(x.shape))) / (2 * eps)
    return g


@pytest.fixture
def fd():
    return fd_grad


# --- fast-pass split ------------------------------------------------------
# Tests that take >= ~24 s on CPU carry the `slow` marker, applied
# centrally here so the list is maintainable.  `pytest -m "not slow"` is
# the per-commit fast pass; the full suite runs without the filter.
SLOW_TESTS = {
    "test_10A_cutoff_family",
    "test_library_regeneration_end_to_end",
    "test_full_forcefield_energy_and_forces",
    "test_reference_style_sidechain_up_loads_and_runs",
    "test_sharded_full_forcefield_advance",
    "test_sharded_hamiltonian_full_forcefield_advance",
    "test_reference_style_up_loads_and_runs",
    "test_backbone_config_roundtrip",
    "test_stream_values_and_shapes",
    "test_restricted_system_pins_states",
    "test_generated_library_runs_pipeline",
    "test_full_forcefield_cli",
    "test_chi1_cli",
    "test_sharded_full_forcefield_rex_and_training",
    "test_continue_sim",
    "test_analysis_tools",
    "test_energy_gap_training_recovers_accuracy",
    "test_engine_api_roundtrip",
    "test_sens_equals_bead_marginals",
    "test_environment_chain_fd",
    "test_cli_replica_exchange",
    "test_uniform_transform_linear_coupling_fd",
    "test_full_forcefield_md_short",
    "test_membrane_fd",
    "test_bp_loopy_envelope_gradient",
    "test_backbone_md_runs_and_equipartitions",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
