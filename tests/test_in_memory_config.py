"""The in-memory route: ConfigBuilder.to_group and library Groups load
exactly like the HDF5 round trip, and importing, building and advancing a
system needs no h5py."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from upside_md.bench_systems import TRP_CAGE, full_builder, seeded_libraries
from upside_md.config.reader import load_system
from upside_md.config.tree import Dataset, Group, write_h5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _energy_and_forces(loaded):
    system, params, pos, _ = loaded
    e, g = jax.value_and_grad(system.energy)(jnp.asarray(pos), params)
    return float(e), np.asarray(g)


def test_load_system_in_memory_matches_file(tmp_path):
    b = full_builder(TRP_CAGE)
    mem = load_system(b.to_group())
    disk = load_system(b.write(str(tmp_path / "sys.up")))
    assert [s.name for s in mem[0].specs] == [s.name for s in disk[0].specs]
    np.testing.assert_array_equal(mem[2], disk[2])
    assert mem[3].keys() == disk[3].keys()
    e_mem, g_mem = _energy_and_forces(mem)
    e_disk, g_disk = _energy_and_forces(disk)
    assert e_mem == e_disk
    np.testing.assert_array_equal(g_mem, g_disk)


def test_library_group_matches_library_file(tmp_path):
    """A library given as a Group builds the same system as the same
    library written to an .h5 file and given as a path."""
    import h5py
    sc, env = seeded_libraries()
    paths = []
    for name, lib in (("sidechain.h5", sc), ("environment.h5", env)):
        with h5py.File(tmp_path / name, "w") as f:
            write_h5(lib, f)
        paths.append(str(tmp_path / name))
    from_groups = load_system(full_builder(
        TRP_CAGE, sidechain_lib=sc, environment_lib=env).to_group())
    from_files = load_system(full_builder(
        TRP_CAGE, sidechain_lib=paths[0], environment_lib=paths[1]
    ).to_group())
    e1, g1 = _energy_and_forces(from_groups)
    e2, g2 = _energy_and_forces(from_files)
    assert e1 == e2
    np.testing.assert_array_equal(g1, g2)


def test_tree_indexing_like_h5py():
    g = Group({"a": Group({"x": Dataset(np.arange(4), {"unit": "A"})})},
              attrs={"arguments": np.asarray(["pos"], "S")})
    assert "a/x" in g and "a" in g and "a/y" not in g and "b/x" not in g
    assert "a/x/z" not in g
    np.testing.assert_array_equal(np.asarray(g["a/x"]), np.arange(4))
    assert g["/a/x"].attrs == {"unit": "A"}
    assert g["a"]["x"][1:].attrs == {"unit": "A"}   # slices keep attrs
    assert type(np.asarray(g["a/x"])) is np.ndarray
    assert list(g) == ["a"]


def test_build_and_advance_without_h5py():
    """With h5py unimportable the package imports, builds the seeded full
    forcefield in memory and advances it."""
    code = """
import sys
sys.modules["h5py"] = None          # any `import h5py` now fails
import jax.numpy as jnp, numpy as np
import upside_md
from upside_md.bench_systems import TRP_CAGE, build_full_system
from upside_md.md.sim import Simulation
system, params, pos, _ = build_full_system(seq=TRP_CAGE)
sim = Simulation(system, dt=0.009, thermostat_interval=0.027,
                 do_recenter=False)
state = sim.initial_state(pos, params, seed=1, temperature=0.85,
                          n_replica=2)
state = sim.advance(state, params, 2, True)
assert np.all(np.isfinite(np.asarray(state.pos)))
try:
    import h5py  # noqa: F401
except ImportError:
    print("advanced without h5py")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("UPSIDE_PARAM_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "advanced without h5py" in out.stdout
