"""CLI driver, trajectory tools, run orchestration, analysis."""

import os

import h5py
import numpy as np
import pytest

from upside_md.analysis import (attr_overview, diagnose_traj,
                                    energy_blame, radius_of_gyration, rmsd)
from upside_md.config.builder import ConfigBuilder, random_initial_config
from upside_md.io.trajectory import (load_upside_traj,
                                         reconstruct_virtual_atoms,
                                         write_pdb, write_vtf)
from upside_md.run import continue_sim, run_upside, swap_table2d

SEQ = 'MKVLFEGAR'


def small_config(tmp_path, name='sys.up', seed=1):
    rng = np.random.default_rng(0)
    b = ConfigBuilder(f'>x\n{SEQ}\n', seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.3 * rng.normal(size=(b.n_res, 12, 12)))
    b.add_backbone_pairs()
    b.add_hbond(hbond_energy=-2.0)
    return b.write(str(tmp_path / name))


def test_cli_run_and_outputs(tmp_path, capsys):
    path = small_config(tmp_path)
    rc = run_upside([path], duration=2.7, frame_interval=0.27,
                    temperature="0.9", seed=5)
    assert rc == 0
    with h5py.File(path, 'r') as f:
        n_frame = f['output/pos'].shape[0]
        assert n_frame >= 9
        assert f['output/pos'].shape[1:] == (1, 3 * len(SEQ), 3)
        assert np.all(np.isfinite(f['output/pos'][:]))
        assert f['output/potential'].shape[0] == n_frame
    out = capsys.readouterr().out
    assert 'avg_kinetic_energy/1.5kT' in out


def test_cli_replica_exchange(tmp_path):
    paths = [small_config(tmp_path, f's{i}.up', seed=1) for i in range(4)]
    rc = run_upside(paths, duration=1.35, frame_interval=0.27,
                    temperature="0.8,0.9,1.0,1.1", seed=5,
                    extra_args=["--replica-interval=0.27",
                                "--swap-set=0-1,2-3", "--swap-set=1-2"])
    assert rc == 0
    with h5py.File(paths[0], 'r') as f:
        assert 'replica_index' in f['output']


def test_continue_sim(tmp_path):
    path = small_config(tmp_path)
    run_upside([path], duration=0.54, frame_interval=0.27, seed=5)
    with h5py.File(path, 'r') as f:
        last = np.asarray(f['output/pos'])[-1, 0]
    continue_sim([path], duration=0.54, frame_interval=0.27, seed=6)
    with h5py.File(path, 'r') as f:
        assert 'output_previous_0' in f
        np.testing.assert_allclose(np.asarray(f['input/pos'])[:, :, 0], last)
    seq, time, pos = load_upside_traj(path)
    n0 = 0
    with h5py.File(path, 'r') as f:
        n0 = f['output_previous_0/pos'].shape[0] + f['output/pos'].shape[0]
    assert pos.shape[0] == n0


def test_trajectory_tools(tmp_path):
    path = small_config(tmp_path)
    run_upside([path], duration=0.54, frame_interval=0.27, seed=5)
    seq, time, pos = load_upside_traj(path)
    names, residues, xyz = reconstruct_virtual_atoms(seq, pos)
    assert 'CB' in names and 'O' in names and 'H' in names
    assert xyz.shape[0] == pos.shape[0]
    # CB should be ~1.53 A from CA
    for i, nm in enumerate(names):
        if nm == 'CB':
            ca = [j for j in range(len(names))
                  if residues[j] == residues[i] and names[j] == 'CA'][0]
            d = np.linalg.norm(xyz[0, i] - xyz[0, ca])
            assert 1.0 < d < 2.0
    write_vtf(str(tmp_path / 't.vtf'), seq, pos)
    write_pdb(str(tmp_path / 't.pdb'), seq, pos)
    assert os.path.getsize(tmp_path / 't.vtf') > 0
    assert os.path.getsize(tmp_path / 't.pdb') > 0


def test_analysis_tools(tmp_path, rng):
    path = small_config(tmp_path)
    run_upside([path], duration=0.54, frame_interval=0.27, seed=5)
    overview = attr_overview(path)
    assert 'input/potential/dist_spring/id' in overview
    d = diagnose_traj(path)
    assert np.isfinite(d['mean_ke'])

    from upside_md.config.reader import load_system
    system, params, pos, aux = load_system(path)
    blame = energy_blame(system, params, pos)
    assert 'rama_map_pot' in blame

    # rmsd sanity: rotated copy has ~0 rmsd
    x = rng.normal(size=(11, 3))
    from upside_md.ops.geometry import axis_angle_to_rot
    import jax.numpy as jnp
    R = np.asarray(axis_angle_to_rot(jnp.asarray(0.7),
                                     jnp.asarray([0., 0., 1.])))
    assert rmsd(x @ R.T + 3.0, x) < 1e-5
    assert radius_of_gyration(x) > 0


def test_swap_table2d():
    sets = swap_table2d(2, 3)
    # every pair index valid and non-overlapping within a set
    for s in sets:
        seen = set()
        for pair in s.split(','):
            a, b = map(int, pair.split('-'))
            assert a not in seen and b not in seen
            seen.update((a, b))


def test_sigint_graceful_shutdown(tmp_path):
    """kill -INT mid-run leaves a valid .up with all logged frames
    (reference main.cpp:26-89, 610-674)."""
    import os
    import signal
    import subprocess
    import sys
    import threading
    import time

    import h5py

    from upside_md.config.builder import ConfigBuilder

    b = ConfigBuilder(">x\nAAAAAAAA\n", seed=1)
    b.add_backbone_springs()
    path = str(tmp_path / "sig.up")
    b.write(path)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "upside_md.cli", path,
         "--duration", "2000.0", "--frame-interval", "0.25",
         "--temperature", "0.7", "--seed", "4"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

    lines = []
    collector = threading.Thread(
        target=lambda: [lines.append(l) for l in proc.stdout])
    collector.daemon = True
    collector.start()

    # wait for a few per-frame progress lines (stdout is unbuffered), then
    # interrupt mid-run; do NOT touch the h5 file while the writer owns it
    deadline = time.time() + 300
    while time.time() < deadline:
        if sum("potential" in l for l in lines) >= 3:
            break
        time.sleep(0.5)
    assert sum("potential" in l for l in lines) >= 3, lines[-5:]
    proc.send_signal(signal.SIGINT)
    proc.wait(timeout=120)
    collector.join(timeout=10)
    out = "".join(lines)

    assert "finishing current chunk" in out
    # SIGINT is re-raised after the flush, so the exit reflects the signal
    assert proc.returncode != 0

    with h5py.File(path, "r") as f:
        n = f["output/pos"].shape[0]
        assert n >= 3
        assert f["output/time"].shape[0] == n
        assert np.isfinite(f["output/pos"][()]).all()


def test_recycle_structures(tmp_path):
    """--initial-structures: a short structure list recycles over replica
    slots (reference upside_config.py:1296-1301 semantics)."""
    import pickle

    from upside_md.cli import recycle_structures

    rng = np.random.default_rng(3)
    structs = rng.normal(size=(2, 12, 3))
    path = str(tmp_path / "inits.pkl")
    with open(path, "wb") as f:
        pickle.dump(structs, f)

    out = recycle_structures(path, 5, 12)
    assert out.shape == (5, 12, 3)
    np.testing.assert_array_equal(out[0], structs[0])
    np.testing.assert_array_equal(out[1], structs[1])
    np.testing.assert_array_equal(out[2], structs[0])
    np.testing.assert_array_equal(out[4], structs[0])

    # single-structure pickles, incl. the reference's (n_atom, 3, 1) shape
    with open(path, "wb") as f:
        pickle.dump(structs[0][:, :, None], f)
    out = recycle_structures(path, 3, 12)
    assert out.shape == (3, 12, 3)
    np.testing.assert_array_equal(out[2], structs[0])


def test_cli_initial_structures_flag(tmp_path):
    """End to end: the run CLI recycles pickled structures over replica
    slots and actually starts from them."""
    import pickle
    import subprocess
    import sys

    import h5py

    from upside_md.config.builder import ConfigBuilder

    paths = []
    for i in range(3):
        b = ConfigBuilder(">x\nAAAA\n", seed=1)
        b.add_backbone_springs()
        p = str(tmp_path / f"cfg{i}.up")
        b.write(p)
        paths.append(p)

    with h5py.File(paths[0], "r") as f:
        n_atom = f["input/pos"].shape[0]
    # structure 1 = the chain translated 50 A in x (springs are
    # translation-invariant, so the run is equally stable and the slot ->
    # structure mapping is visible through the thermostat noise)
    with h5py.File(paths[0], "r") as f:
        base = np.asarray(f["input/pos"][:]).reshape(n_atom, 3)
    structs = np.stack([base, base + np.array([50.0, 0.0, 0.0])])
    pkl = str(tmp_path / "inits.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(structs, f)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "upside_md.cli", *paths,
         "--duration", "0.1", "--frame-interval", "0.05",
         "--disable-recentering", "--initial-structures", pkl],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    # slots 0 and 2 got structure 0, slot 1 got structure 1
    means = []
    for p in paths:
        with h5py.File(p, "r") as f:
            means.append(np.asarray(f["output/pos"][0]).reshape(
                -1, 3).mean(0)[0])
    assert abs(means[0] - means[2]) < 5.0
    assert means[1] - means[0] > 40.0
