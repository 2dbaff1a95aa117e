"""Multichain config merging with separate interaction graphs."""

import numpy as np
import jax.numpy as jnp

from upside_md.config.builder import ConfigBuilder
from upside_md.config.merge import merge_configs
from upside_md.config.reader import load_system


def _chain_config(tmp_path, name, seq, seed):
    rng = np.random.default_rng(seed)
    b = ConfigBuilder(f'>x\n{seq}\n', seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.2 * rng.normal(size=(b.n_res, 12, 12)))
    b.add_hbond(hbond_energy=-2.0)
    return b.write(str(tmp_path / name)), b


def test_merge_two_chains(tmp_path):
    p1, b1 = _chain_config(tmp_path, 'c1.up', 'MKVLFE', 1)
    p2, b2 = _chain_config(tmp_path, 'c2.up', 'GARTIS', 2)

    # base: both chains' atoms with a cavity
    base = ConfigBuilder('>x\nMKVLFEGARTIS\n',
                         initial_pos=np.concatenate([b1.pos,
                                                     b2.pos + 30.0]),
                         seed=3)
    base.add_cavity_radial(60.0)
    base_path = base.write(str(tmp_path / 'base.up'))

    out = merge_configs(base_path, [p1, p2], str(tmp_path / 'merged.up'))
    system, params, pos, aux = load_system(out)
    assert system.n_atom == 36
    total, outputs, per_term = system.evaluate(jnp.asarray(pos), params)
    assert np.isfinite(float(total))
    # both chains' terms present and independent
    assert 'rama_map_pot_0' in per_term and 'rama_map_pot_1' in per_term
    assert 'cavity_radial' in per_term

    # chain 1 terms equal the standalone chain evaluated at its coords
    s1, params1, pos1, _ = load_system(p1)
    e1 = s1.evaluate(jnp.asarray(pos[:18]), params1)[2]['rama_map_pot']
    np.testing.assert_allclose(float(per_term['rama_map_pot_0']), float(e1),
                               rtol=1e-5)
