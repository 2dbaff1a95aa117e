"""Seeded full-forcefield libraries (bench_systems.seeded_libraries): the
shipped shapes and knot families, determinism, and a BP solve on the
initial structure that needs several sweeps and converges."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from upside_md.bench_systems import (FAMILY_10A, SC_BB, SC_SC, TRP_CAGE,
                                     UBIQUITIN, build_full_system,
                                     rotamer_count, seeded_libraries)
from upside_md.config.builder import THREE_LETTER_AA
from upside_md.nodes.rotamer import bp_solve_health
from upside_md.ops.pairs import quadspline_family


@pytest.mark.parametrize("family", ["default", "10A"])
def test_seeded_library_shapes(family):
    sc, env = seeded_libraries(family=family)
    fam_sc, fam_bb = ((FAMILY_10A, FAMILY_10A) if family == "10A"
                      else (SC_SC, SC_BB))
    n_type = 20
    restypes = [s.decode() for s in np.asarray(sc["restype_order"])]
    assert restypes == sorted(THREE_LETTER_AA.values())
    ss = np.asarray(sc["rotamer_start_stop_bead"])
    assert ss.shape == (n_type, 3) and np.all(ss[:, 2] == 1)
    n_rows = int(ss[-1, 1])
    assert n_rows == sum(rotamer_count(rt) for rt in restypes)
    assert np.asarray(sc["rotamer_center_fixed"]).shape == (n_rows, 6)
    assert np.asarray(sc["rotamer_prob"]).shape == (36, 36, n_rows)
    assert len(np.asarray(sc["bead_order"])) == n_type
    for name, n1, fam in (("pair_interaction", n_type, fam_sc),
                          ("coverage_interaction", 2, fam_bb),
                          ("hydrophobe_interaction", 3, fam_bb)):
        t = np.asarray(sc[name])
        assert t.shape[:2] == (n1, n_type), name
        assert quadspline_family(t.shape[-1]) == fam, name
    assert np.asarray(sc["hydrophobe_placement"]).shape == (3, 7)
    assert np.asarray(env["coverage_param"]).shape == (n_type, 1, 4)
    assert np.asarray(env["energies"]).shape[0] == n_type
    assert {"offset", "inv_dx"} <= set(env["energies"].attrs)
    # the pair table is symmetric under swapping the two beads
    pt = np.asarray(sc["pair_interaction"])
    ka = fam_sc[0]
    np.testing.assert_array_equal(pt[..., :ka],
                                  np.swapaxes(pt[..., ka:2 * ka], 0, 1))
    np.testing.assert_array_equal(pt[..., 2 * ka:],
                                  np.swapaxes(pt[..., 2 * ka:], 0, 1))


def test_seeded_libraries_deterministic():
    a, ea = seeded_libraries(seed=3)
    b, eb = seeded_libraries(seed=3)
    c, _ = seeded_libraries(seed=4)
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]),
                                      np.asarray(b[name]))
    for name in ea:
        np.testing.assert_array_equal(np.asarray(ea[name]),
                                      np.asarray(eb[name]))
    assert not np.array_equal(np.asarray(a["pair_interaction"]),
                              np.asarray(c["pair_interaction"]))


def test_rotamer_count_classes():
    counts = {rt: rotamer_count(rt) for rt in THREE_LETTER_AA.values()}
    assert {rt for rt, n in counts.items() if n == 1} == {"ALA", "GLY"}
    assert {rt for rt, n in counts.items() if n == 3} == {
        "CYS", "SER", "THR", "VAL"}
    assert set(counts.values()) == {1, 3, 6}


@pytest.mark.parametrize("seq", [TRP_CAGE, UBIQUITIN],
                         ids=["trp_cage", "ubiquitin"])
def test_seeded_full_system_bp_converges(seq):
    """At the production tol the BP solve on the initial structure needs
    more than one check chunk and converges before max_iter, both from
    the uniform start and warm-started; energy and forces are finite."""
    system, params, pos, _ = build_full_system(seq=seq)
    names = {s.node_type.name for s in system.specs}
    assert {"rotamer", "protein_hbond", "hbond_coverage",
            "environment_coverage", "nonlinear_coupling"} <= names
    rot = [s for s in system.specs if s.node_type.name == "rotamer"][0]
    tol, max_iter = float(rot.consts["tol"]), int(rot.consts["max_iter"])
    assert tol == 1e-3

    def step(p, cache):
        return jax.value_and_grad(
            lambda q: system.energy_and_cache(q, params, cache=cache),
            has_aux=True)(p)

    step = jax.jit(step)
    p = jnp.asarray(pos)
    (e, cache), g = step(p, system.init_cache())
    dev, sweeps = bp_solve_health(cache[rot.name])
    assert np.isfinite(float(e)) and np.all(np.isfinite(np.asarray(g)))
    assert 2 < int(sweeps) < max_iter and float(dev) <= tol
    (_, cache), _ = step(p + 0.01, cache)
    dev, sweeps = bp_solve_health(cache[rot.name])
    assert 2 <= int(sweeps) < max_iter and float(dev) <= tol
