"""Canonical benchmark systems.

Builds the benchmark configurations from the reference parameter libraries
when UPSIDE_PARAM_DIR names a directory holding them, and otherwise from
seeded libraries generated here at the shipped shapes (`seeded_libraries`).
Either way the full forcefield is built in memory: no `.up` file is
written and no h5py is needed.
"""

from __future__ import annotations

import os

import numpy as np

from .config.builder import (THREE_LETTER_AA, ConfigBuilder,
                             uniform_rama_maps_from_reference)
from .config.reader import load_system
from .config.tree import Dataset, Group

PARAM_DIR = os.environ.get("UPSIDE_PARAM_DIR", "")
RAMA_REF = f"{PARAM_DIR}/common/rama_reference.pkl"
SIDECHAIN = f"{PARAM_DIR}/ff_1/sidechain.h5"
SIDECHAIN_10A = f"{PARAM_DIR}/packing/sidechain_10A_cutoff.h5"
ENVIRONMENT = f"{PARAM_DIR}/ff_1/environment.h5"

TRP_CAGE = "NLYIQWLKDGGPSSGRPPPS"                       # 1L2Y, 20 res
UBIQUITIN = ("MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQ"
             "QRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG")     # 1UBQ, 76 res
PROTEIN_G = "MTYKLILNGKTLKGETTTEAVDAATAEKVFKQYANDNGVDGEWTYDDATKTFTVTE"
# horse cytochrome c, 104 res: the ~100-residue Hamiltonian
# replica-exchange system
CYT_C = ("GDVEKGKKIFVQKCAQCHTVEKGGKHKTGPNLHGLFGRKTGQAPGFTYTDANKNKGITW"
         "KEETLMEYLENPKKYIPGTKMIFAGIKKKTEREDLIAYLKKATNE")

# Quadspline knot families (n_knot_angular, n_knot, dx) of the shipped
# tables (ops.pairs.quadspline_family): sidechain-sidechain and
# sidechain-backbone, and the 10 A family used for both.
SC_SC = (8, 9, 1.0)
SC_BB = (8, 7, 1.0)
FAMILY_10A = (8, 12, 1.0)

# hydrophobic restypes: attractive pair wells and favoured burial in the
# seeded tables
HYDROPHOBIC = {"ALA", "CYS", "ILE", "LEU", "MET", "PHE", "PRO", "TRP",
               "TYR", "VAL"}


def have_reference_params():
    return bool(PARAM_DIR) and os.path.exists(SIDECHAIN) and \
        os.path.exists(RAMA_REF)


def _rama_maps(n_res):
    if have_reference_params():
        return uniform_rama_maps_from_reference(n_res, RAMA_REF)
    # seeded map, normalized like the reference's -log probability maps
    rng = np.random.default_rng(0)
    base = 0.5 * rng.normal(size=(1, 72, 72))
    base = base + np.log(np.exp(-base).sum())
    return np.tile(base, (n_res, 1, 1))


def rotamer_count(restype):
    """Rotamer states of a restype in the reference's 1/3/6 classes.

    Assumed, as the repository records no per-restype count: 1 for ALA
    and GLY, 3 for the one-chi residues (CYS, SER, THR, VAL), 6 for the
    rest."""
    from .sidechain_topology import N_CHI
    if restype in ("ALA", "GLY"):
        return 1
    return 3 if N_CHI[restype] == 1 else 6


def _rotamer_beads(restype):
    """One bead per rotamer in the residue frame: (n_rot, 6) rows of the
    side chain's atom centroid beyond CB and its unit direction from CB.
    Rotamers take chi1 in (-60, 180, 60) degrees and, for the 6-state
    class, chi2 in (180, 60); ALA places its bead at CB and GLY at CA."""
    from .sidechain_topology import atom_names, residue_atoms
    names = atom_names(restype)
    n_rot = rotamer_count(restype)
    chi1 = np.deg2rad([-60.0, 180.0, 60.0])
    chi2 = np.deg2rad([180.0, 60.0])
    rows = []
    for r in range(n_rot):
        chi = (chi1[r % 3], chi2[r // 3], np.pi, np.pi)
        atoms = residue_atoms(restype, psi=np.deg2rad(130.0), chi=chi)
        if restype == "GLY":
            center = atoms[names.index("CA")]
            anchor = 0.5 * (atoms[names.index("N")] + atoms[names.index("C")])
        elif restype == "ALA":
            center = atoms[names.index("CB")]
            anchor = atoms[names.index("CA")]
        else:
            center = atoms[names.index("CB") + 1:].mean(0)
            anchor = atoms[names.index("CB")]
        d = center - anchor
        rows.append(np.concatenate([center, d / np.linalg.norm(d)]))
    return np.asarray(rows)


def _rotamer_probs(rng, n_rot, n_bin=36):
    """(n_bin, n_bin, n_rot) per-(phi, psi)-bin rotamer probabilities with
    a smooth, seeded backbone dependence."""
    ang = (np.arange(n_bin) + 0.5) * 2 * np.pi / n_bin - np.pi
    phi, psi = np.meshgrid(ang, ang, indexing="ij")
    c = rng.normal(size=(n_rot, 5))
    logit = (c[:, 0, None, None]
             + 0.5 * c[:, 1, None, None] * np.cos(phi)
             + 0.5 * c[:, 2, None, None] * np.sin(phi)
             + 0.5 * c[:, 3, None, None] * np.cos(psi)
             + 0.5 * c[:, 4, None, None] * np.sin(psi))
    p = np.exp(logit - logit.max(0))
    return np.transpose(p / p.sum(0), (1, 2, 0))


def _quadspline_table(rng, n1, n2, family, well, symmetric=False):
    """(n1, n2, 2*ka + 2*k) directional bead-pair spline table.

    wide(r): a repulsive core plus an attractive well of depth well[a, b]
    centred near 4.5 A; narrow(r): a directional well of the same depth
    scale gated by the two angular splines (cos of each bead's direction
    against the pair axis, favouring beads that point at each other).
    The last three radial knots are zero so the pair energy vanishes
    smoothly at the cutoff (k - 2) * dx."""
    ka, k, dx = family
    r = np.arange(k) * dx - dx           # knot m sits at r = (m - 1) dx
    core = 3.0 * np.exp(-0.5 * (np.maximum(r, 0.0) / 1.6) ** 2)
    well_shape = np.exp(-0.5 * ((r - 4.5) / 1.2) ** 2)
    radial = core[None, None] - well[..., None] * well_shape[None, None]
    narrow = -0.5 * well[..., None] * well_shape[None, None]
    radial[..., k - 3:] = 0.0
    narrow[..., k - 3:] = 0.0
    cos_knot = (np.arange(ka) - 1) * 2.0 / (ka - 3) - 1.0
    ang = 0.5 + 0.5 * np.clip(cos_knot, -1.0, 1.0)
    ang1 = ang[None, None] * (1.0 + 0.1 * rng.normal(size=(n1, n2, 1)))
    ang2 = ang[None, None] * (1.0 + 0.1 * rng.normal(size=(n1, n2, 1)))
    if symmetric:
        ang2 = np.transpose(ang1, (1, 0, 2))
    return np.concatenate([ang1, ang2, radial, narrow], axis=-1)


def seeded_libraries(seed=0, family="default"):
    """Sidechain and environment libraries generated from `seed` alone, in
    the layouts and at the shapes of the reference's ff_1 `sidechain.h5`
    and `environment.h5` (for family="10A", the 10 A-cutoff packing
    library).  Returns (sidechain, environment) as in-memory Groups that
    ConfigBuilder.add_rotamer_sidechains / add_hbond / add_environment
    take in place of file paths.

    The sidechain library holds one bead type per restype, one bead per
    rotamer (rotamer_count), per-(phi, psi)-bin rotamer probabilities,
    the pair table (SC_SC family, or FAMILY_10A), the donor/acceptor
    coverage and 3-point hydrophobe tables (SC_BB, or FAMILY_10A) and the
    hydrophobe placement.  Pair wells are deepest between hydrophobic
    types; their scale (about 1 energy unit) makes belief propagation on
    an extended chain take several sweeps at the production tolerance.
    These are not trained parameters: they exercise every term of the
    full forcefield at its real shapes."""
    from .param_gen import placement_library
    if family not in ("default", "10A"):
        raise ValueError(f"unknown knot family {family!r}")
    sc_sc, sc_bb = ((FAMILY_10A, FAMILY_10A) if family == "10A"
                    else (SC_SC, SC_BB))
    rng = np.random.default_rng(seed)
    restypes = sorted(THREE_LETTER_AA.values())
    n_type = len(restypes)
    lib = placement_library({
        rt: dict(centers=_rotamer_beads(rt), n_bead=1,
                 probs=_rotamer_probs(rng, rotamer_count(rt)))
        for rt in restypes})

    hyd = np.array([rt in HYDROPHOBIC for rt in restypes], float)
    well = 0.3 + 0.9 * np.outer(hyd, hyd) + 0.2 * rng.random((n_type,
                                                             n_type))
    well = 0.5 * (well + well.T)
    lib["pair_interaction"] = Dataset(
        _quadspline_table(rng, n_type, n_type, sc_sc, well, symmetric=True))
    lib["coverage_interaction"] = Dataset(_quadspline_table(
        rng, 2, n_type, sc_bb, 0.3 + 0.3 * rng.random((2, n_type))))
    lib["hydrophobe_interaction"] = Dataset(_quadspline_table(
        rng, 3, n_type, sc_bb, 0.2 + 0.4 * hyd[None] *
        rng.random((3, n_type))))
    # three hydrophobe points per residue (N, CA, C directions), each row
    # position, unit direction and a zero hbond scalar
    from .config.builder import REF_C, REF_CA, REF_N
    pts = np.array([REF_N, REF_CA, REF_C])
    pts = pts - pts.mean(0)
    dirs = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    lib["hydrophobe_placement"] = Dataset(
        np.concatenate([pts, dirs, np.zeros((3, 1))], axis=-1))

    # environment: burial coverage of each CB by sidechain beads, and a
    # per-restype clamped spline of burial (hydrophobic types favour it)
    n_coeff, inv_dx = 12, 0.5
    burial = (np.arange(n_coeff) - 1) / inv_dx
    pref = np.where(hyd > 0, -1.0, 0.5) * (0.5 + 0.5 * rng.random(n_type))
    energies = pref[:, None] * (1.0 - np.exp(-np.maximum(burial, 0) / 6.0))
    cov = np.zeros((n_type, 1, 4))
    cov[:, 0] = [6.5, 0.5, 0.0, 2.0]     # r0, r_sharp, dot0, dot_sharp
    env = Group({
        "restype_order": Dataset(np.asarray(restypes, "S")),
        "coverage_param": Dataset(cov),
        "energies": Dataset(energies, {"offset": -1.0 / inv_dx,
                                       "inv_dx": inv_dx}),
    })
    return lib, env


def build_backbone_system(seq=TRP_CAGE, hbond_energy=-2.1119, seed=1):
    """Constant-T backbone potential (bonds + Rama map + HBond + steric)."""
    b = ConfigBuilder(f">x\n{seq}\n", seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(_rama_maps(b.n_res))
    b.add_backbone_pairs()
    b.add_hbond(hbond_energy=hbond_energy)
    return load_system(b.to_group())


def full_builder(seq=UBIQUITIN, hbond_energy=-2.1119, seed=1,
                 sidechain_lib=None, environment_lib=None, family="default"):
    """ConfigBuilder of the full forcefield: rotamer BP sidechains, hbond
    coverage and hydrophobes, and the environment/burial chain.
    Libraries default to the reference's when present, else to
    seeded_libraries(family)."""
    if sidechain_lib is None or environment_lib is None:
        if have_reference_params():
            ref_sc = SIDECHAIN_10A if family == "10A" else SIDECHAIN
            sidechain_lib = sidechain_lib or ref_sc
            environment_lib = environment_lib or ENVIRONMENT
        else:
            seeded_sc, seeded_env = seeded_libraries(family=family)
            sidechain_lib = sidechain_lib or seeded_sc
            environment_lib = environment_lib or seeded_env
    b = ConfigBuilder(f">x\n{seq}\n", seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(_rama_maps(b.n_res))
    b.add_backbone_pairs()
    # damping 0.1: solver schedule only (same fixed point as the reference
    # default 0.4); tools/bp_damping_exp.py compares the sweep counts
    b.add_rotamer_sidechains(sidechain_lib, sidechain_lib, damping=0.1,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=hbond_energy, coverage_library=sidechain_lib)
    b.add_environment(environment_lib)
    b.add_rotamer_node()
    return b


def build_full_system(seq=UBIQUITIN, hbond_energy=-2.1119, seed=1,
                      sidechain_lib=None, environment_lib=None,
                      family="default"):
    """The full forcefield (full_builder), loaded in memory.  Returns
    (System, params, initial_pos, aux)."""
    return load_system(full_builder(seq, hbond_energy, seed, sidechain_lib,
                                    environment_lib, family).to_group())


def build_10A_system(seq=PROTEIN_G, seed=1):
    """10-Angstrom-cutoff parameter family (the reference needs a
    PARAM_10A_CUTOFF rebuild; here the knot family is inferred from the
    table shapes at runtime)."""
    return build_full_system(seq=seq, seed=seed, family="10A")
