"""Builder extras: chain breaks, restraints, z/tension/AFM, secstr bias."""

import numpy as np
import jax
import jax.numpy as jnp

from upside_md.config.builder import (ConfigBuilder, apply_secstr_bias)
from upside_md.config.reader import load_system
from upside_md.md.mc import JumpSampler


def _base(tmp_path, seq='MKVLAEGARSKV', **kw):
    rng = np.random.default_rng(0)
    b = ConfigBuilder(f'>x\n{seq}\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.3 * rng.normal(size=(b.n_res, 12, 12)))
    return b


def test_chain_breaks(tmp_path):
    b = _base(tmp_path)
    b.add_chain_breaks([6])
    b.add_hbond(hbond_energy=-2.0, exclude_residues=[5, 6])
    path = b.write(str(tmp_path / 'mc.up'))
    system, params, pos, aux = load_system(path)
    assert 'chain_break' in aux and 'jump_moves' in aux

    # no bonded springs cross the break (atoms 17|18)
    ds = system.by_name['dist_spring'].consts['id']
    assert not np.any((ds[:, 0] < 18) & (ds[:, 1] >= 18))
    # rama dummies at the break
    rc = system.by_name['rama_coord']
    assert rc.consts['dummy'][6, 0] and rc.consts['dummy'][5, 1]

    e = float(system.energy(jnp.asarray(pos), params))
    assert np.isfinite(e)
    # jump sampler works on the two chains
    jm = aux['jump_moves']
    js = JumpSampler(jm['atom_range'], jm['sigma_trans'], jm['sigma_rot'])
    new_pos, _ = js.propose(jax.random.PRNGKey(0), jnp.asarray(pos))
    assert np.isfinite(np.asarray(new_pos)).all()


def test_restraint_group(tmp_path):
    b = _base(tmp_path)
    n_before = len(b.groups['dist_spring']['datasets']['id'])
    b.add_restraint_group([2, 3, 4], strength=4.0)
    ds = b.groups['dist_spring']['datasets']
    assert len(ds['id']) > n_before
    # restraints are at the initial distances => they add zero energy
    b0 = _base(tmp_path)
    p0 = b0.write(str(tmp_path / 'rg0.up'))
    path = b.write(str(tmp_path / 'rg.up'))
    s0, params0, pos0, _ = load_system(p0)
    s1, params1, pos1, _ = load_system(path)
    e0 = float(s0.evaluate(jnp.asarray(pos0), params0)[2]['dist_spring'])
    e1 = float(s1.evaluate(jnp.asarray(pos1), params1)[2]['dist_spring'])
    assert abs(e1 - e0) < 1e-4


def test_z_tension_afm(tmp_path):
    b = _base(tmp_path)
    b.add_z_flat_bottom([(2, 0.0, 3.0, 5.0)])
    b.add_tension([(3, 0.1, 0.0, -0.2)])
    b.add_afm([(4, 2.0, 1.0, 0.0, 0.0, 0.01, 0.0, 0.0)])
    path = b.write(str(tmp_path / 'zt.up'))
    system, params, pos, aux = load_system(path)
    total, _, per_term = system.evaluate(jnp.asarray(pos), params)
    for t in ('z_flat_bottom', 'tension', 'AFM'):
        assert t in per_term
    # AFM tip moves with the force-eval counter
    e0 = system.evaluate(jnp.asarray(pos), params,
                         extra={'n_deriv_evals': 0})[2]['AFM']
    e1 = system.evaluate(jnp.asarray(pos), params,
                         extra={'n_deriv_evals': 3000})[2]['AFM']
    assert abs(float(e0) - float(e1)) > 1e-8


def test_secstr_bias():
    rng = np.random.default_rng(0)
    pot = 0.1 * rng.normal(size=(5, 24, 24))
    biased = apply_secstr_bias(pot, [(2, 'helix', -1.0), (3, 'sheet', -0.5)])
    assert biased.shape == pot.shape
    # helical basin (phi<0, -100<psi<50) got more negative for residue 2
    dphi = biased[2] - pot[2]
    assert dphi.min() < -0.9
    assert abs(biased[0] - pot[0]).max() < 1e-12
