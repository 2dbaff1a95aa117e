"""Entry points around the device: the compile-cache location, and the
GPU-only scripts refusing to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from upside_md.compile_cache import CHECKOUT_ROOT, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the
    cache sits at <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "unchanged")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache()
            assert path == os.path.join(CHECKOUT_ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert os.path.samefile(CHECKOUT_ROOT, REPO)
        else:
            target = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
            assert enable_compile_cache() == target
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_without_gpu(script):
    """On the CPU backend both exit non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                         env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "gpu" in (out.stdout + out.stderr).lower()


@pytest.mark.gpu
def test_gpu_energy_and_forces_match_cpu():
    """On the card: the seeded full forcefield (Trp-cage) agrees with the
    CPU backend of the same process at float32, "highest" precision."""
    import jax.numpy as jnp
    import numpy as np

    from upside_md.bench_systems import TRP_CAGE, build_full_system
    system, params, pos, _ = build_full_system(seq=TRP_CAGE)

    def run(device):
        with jax.default_matmul_precision("highest"):
            f = jax.jit(jax.value_and_grad(system.energy))
            p = jax.device_put(jnp.asarray(pos, jnp.float32), device)
            e, g = f(p, jax.device_put(params, device))
            return float(e), np.asarray(g)

    e_gpu, g_gpu = run(jax.devices("gpu")[0])
    e_cpu, g_cpu = run(jax.devices("cpu")[0])
    assert abs(e_gpu - e_cpu) <= 1e-4 * abs(e_cpu)
    rms = np.sqrt(np.mean((g_gpu - g_cpu) ** 2) / np.mean(g_cpu ** 2))
    assert rms <= 1e-3
