"""Membrane thickness-rescale property tests (semantics of
upside_config.py:1064-1120, pinned here so the vectorized rewrite in
ConfigBuilder.add_membrane_potential stays behaviorally correct):

* target thickness == library thickness: profiles reproduce the library,
* thinner target: leaflets overlap and the profile is CONTINUOUS at z=0,
* thicker target: the inserted midplane region is flat at the library's
  z=0 value, and the outer profile is a rigid translation,
* beyond the library range the profile extends flat.
"""

import h5py
import numpy as np
import pytest

from upside_md.config.builder import ConfigBuilder

SEQ = "ACDEFGHIKLMNPQRSTVWY"
RESNAMES = ["ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
            "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
            "TYR", "VAL", "NON"]
LIB_THICKNESS = 30.0
Z_MIN, Z_MAX, NZ = -25.0, 25.0, 101


def make_library(path, rng):
    z = np.linspace(Z_MIN, Z_MAX, NZ)
    n = len(RESNAMES)
    # smooth, asymmetric profiles so continuity violations are visible
    phase = rng.uniform(0, np.pi, size=(n, 1))
    cb = np.sin(z[None, :] / 7.0 + phase) + 0.03 * z[None, :]
    uhb = np.cos(z[None, :] / 5.0 + phase[:2])
    with h5py.File(path, "w") as f:
        f["names"] = np.array([s.encode() for s in RESNAMES])
        d = f.create_dataset("cb_energy", data=cb)
        d.attrs["z_min"], d.attrs["z_max"] = Z_MIN, Z_MAX
        d.attrs["thickness"] = LIB_THICKNESS
        d = f.create_dataset("uhb_energy", data=uhb)
        d.attrs["z_min"], d.attrs["z_max"] = Z_MIN, Z_MAX
        f["cov_midpoint"] = np.full(n, 2.0)
        f["cov_sharpness"] = np.full(n, 1.0)
    return z, cb


def build(tmp_path, rng, thickness):
    lib = str(tmp_path / "membrane.h5")
    z_lib, cb_lib = make_library(lib, rng)
    b = ConfigBuilder(f">x\n{SEQ}\n", seed=1)
    b.add_backbone_springs()
    b.add_membrane_potential(lib, membrane_thickness=thickness)
    g = b.groups["membrane_potential"]
    zg = np.linspace(g["attrs"]["cb_energy:z_min"],
                     g["attrs"]["cb_energy:z_max"],
                     g["datasets"]["cb_energy"].shape[-1])
    return z_lib, cb_lib, zg, np.asarray(g["datasets"]["cb_energy"])


def test_same_thickness_reproduces_library(tmp_path, rng):
    z_lib, cb_lib, zg, cb = build(tmp_path, rng, LIB_THICKNESS)
    inside = (zg >= Z_MIN) & (zg <= Z_MAX)
    ref = np.stack([np.interp(zg[inside], z_lib, e) for e in cb_lib])
    # cubic-vs-linear interpolation tolerance on a smooth profile
    np.testing.assert_allclose(cb[:, inside], ref, atol=5e-3)
    # flat extension beyond the library range
    np.testing.assert_allclose(cb[:, zg < Z_MIN],
                               np.broadcast_to(cb_lib[:, :1],
                                               cb[:, zg < Z_MIN].shape),
                               atol=1e-5)
    np.testing.assert_allclose(cb[:, zg > Z_MAX],
                               np.broadcast_to(cb_lib[:, -1:],
                                               cb[:, zg > Z_MAX].shape),
                               atol=1e-5)


@pytest.mark.parametrize("thickness", [20.0, 42.0])
def test_continuity_at_zero(tmp_path, rng, thickness):
    _, _, zg, cb = build(tmp_path, rng, thickness)
    i = np.searchsorted(zg, 0.0)
    # grid spacing is 0.25; a continuous profile changes by O(slope*dz)
    jump = np.abs(cb[:, i] - cb[:, i - 1])
    assert np.max(jump) < 0.15, np.max(jump)


def test_thicker_is_translated_with_flat_midplane(tmp_path, rng):
    thickness = LIB_THICKNESS + 12.0
    z_lib, cb_lib, zg, cb = build(tmp_path, rng, thickness)
    dt = (thickness - LIB_THICKNESS) / 2.0
    # midplane region equals the library z=0 value
    mid = np.abs(zg) <= dt - 0.25
    z0_val = np.stack([np.interp(0.0, z_lib, e) for e in cb_lib])
    np.testing.assert_allclose(cb[:, mid],
                               np.broadcast_to(z0_val[:, None],
                                               cb[:, mid].shape), atol=5e-3)
    # outside: rigid translation of the library profile
    sel = (zg > dt) & (zg - dt >= Z_MIN) & (zg - dt <= Z_MAX)
    ref = np.stack([np.interp(zg[sel] - dt, z_lib, e) for e in cb_lib])
    np.testing.assert_allclose(cb[:, sel], ref, atol=5e-3)


def test_thinner_splits_mismatch_symmetrically(tmp_path, rng):
    thickness = LIB_THICKNESS - 10.0
    z_lib, cb_lib, zg, cb = build(tmp_path, rng, thickness)
    dt = (LIB_THICKNESS - thickness) / 2.0
    # left half: spl(z - dt) + dsym/2 with dsym = spl(dt) - spl(-dt)
    dsym = np.stack([np.interp(dt, z_lib, e) - np.interp(-dt, z_lib, e)
                     for e in cb_lib])
    sel = (zg < -0.5) & (zg - dt >= Z_MIN)
    ref = np.stack([np.interp(zg[sel] - dt, z_lib, e)
                    for e in cb_lib]) + 0.5 * dsym[:, None]
    np.testing.assert_allclose(cb[:, sel], ref, atol=5e-3)
