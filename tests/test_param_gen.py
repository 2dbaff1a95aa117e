"""Parameter-library generation tools: build a synthetic sidechain library
and run it through the full rotamer pipeline."""

import numpy as np
import jax.numpy as jnp

from upside_md.analysis import rama_density, rdc, sim_timeseries
from upside_md.config.builder import ConfigBuilder, random_initial_config
from upside_md.config.reader import load_system
from upside_md.param_gen import (build_sidechain_from_internal,
                                     kmeans_bead_centers,
                                     rama_binned_rotamer_probs,
                                     write_placement_library)


def test_internal_coordinate_growth():
    prev = np.zeros(3)
    atoms = build_sidechain_from_internal(
        prev, torsions=[0.0, np.pi, np.pi / 3],
        angles=[109.5 * np.pi / 180] * 3, lengths=[1.5, 1.5, 1.5])
    assert atoms.shape == (3, 3)
    d = np.linalg.norm(np.diff(np.vstack([prev[None], atoms]), axis=0),
                       axis=-1)
    np.testing.assert_allclose(d, 1.5, atol=1e-10)


def test_kmeans_and_probs(rng):
    pts = np.concatenate([rng.normal(size=(50, 3)),
                          rng.normal(size=(50, 3)) + 8.0])
    centers, assign = kmeans_bead_centers(pts, 2, seed=1)
    assert centers.shape == (2, 3)
    assert abs(np.linalg.norm(centers[0] - centers[1]) - 8 * 3 ** 0.5) < 3.0

    phi = rng.uniform(-np.pi, np.pi, 500)
    psi = rng.uniform(-np.pi, np.pi, 500)
    rot = (phi > 0).astype(int)  # rotamer correlates with phi
    probs = rama_binned_rotamer_probs(phi, psi, rot, n_bin=12)
    assert probs.shape == (12, 12, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-12)
    assert probs[0, :, 0].mean() > 0.7   # phi<0 bins favor rotamer 0
    assert probs[-1, :, 1].mean() > 0.7


def test_generated_library_runs_pipeline(tmp_path, rng):
    # 1-bead, 3-rotamer synthetic library for every standard restype
    restypes = ['ALA', 'ARG', 'ASN', 'ASP', 'CYS', 'GLN', 'GLU', 'GLY',
                'HIS', 'ILE', 'LEU', 'LYS', 'MET', 'PHE', 'PRO', 'SER',
                'THR', 'TRP', 'TYR', 'VAL']
    data = {}
    for rt in restypes:
        n_rot = 1 if rt in ('ALA', 'GLY') else 3
        c = np.zeros((n_rot, 6))
        c[:, 0:3] = 1.5 * rng.normal(size=(n_rot, 3)) + [0.0, 1.0, 1.2]
        d = rng.normal(size=(n_rot, 3))
        c[:, 3:6] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        data[rt] = {'centers': c, 'n_bead': 1, 'probs': None}
    lib = write_placement_library(str(tmp_path / 'sidechain_gen.h5'), data)

    # pair-interaction table in the default knot family
    import h5py
    ka, k = 8, 9
    with h5py.File(lib, 'a') as f:
        n_type = 20
        tbl = np.zeros((n_type, n_type, 2 * ka + 2 * k))
        tbl[..., :2 * ka] = 1.0
        dist = 0.1 * rng.normal(size=(2 * k,))
        dist[k - 3:k] = 0.0
        dist[2 * k - 3:] = 0.0
        tbl[..., 2 * ka:] = dist
        f.create_dataset('pair_interaction', data=tbl)
        f.create_dataset('coverage_interaction',
                         data=np.zeros((2, n_type, 2 * ka + 2 * 7)))
        f.create_dataset('hydrophobe_interaction',
                         data=np.zeros((3, n_type, 2 * ka + 2 * 7)))
        f.create_dataset('hydrophobe_placement', data=np.zeros((3, 7)))

    b = ConfigBuilder('>x\nMKVLFEGARTIS\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.2 * rng.normal(size=(b.n_res, 12, 12)))
    b.add_rotamer_sidechains(lib, lib, damping=0.4, dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.0, coverage_library=lib)
    b.add_rotamer_node()
    path = b.write(str(tmp_path / 'gen.up'))
    system, params, pos, aux = load_system(path)
    e = float(system.energy(jnp.asarray(pos), params))
    assert np.isfinite(e)


def test_analysis_extensions(rng, tmp_path):
    # rama KDE normalizes roughly to a density over the torus
    rama = rng.uniform(-np.pi, np.pi, size=(200, 2))
    dens = rama_density(rama, bandwidth=0.5, n_bins=24)
    assert dens.shape == (24, 24) and (dens > 0).all()
    # roughly uniform samples -> roughly uniform density
    assert dens.max() / dens.min() < 20

    pos = random_initial_config(10, seed=2)
    out = rdc(pos)
    assert len(out) == 3 and out[0][1].shape == (9,)
