"""Chi1 rotamer-state prediction (reference: py/predict_chi1.py).

Pipeline: PDB -> config (loose hbond criteria, dynamic rotamer 1-body, no
backbone sterics, basic springs disabled) -> one energy evaluation ->
sensitivities of the hbond_coverage output (= posterior bead marginals by
the envelope theorem) -> chi1-state probabilities per residue.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

deg = np.pi / 180.0


def compute_chi1_state(chi1):
    return (((chi1 / deg) % 360.0) / 120.0).astype('i')


class Chi1Predict:
    """Map rotamer-state posteriors to chi1-bin probabilities.

    The sidechain library's restype_and_chi_and_state table assigns every
    library rotamer state a chi1 angle; states bucket into the three
    120-degree chi1 wells.  Internally this is a dense lookup
    state_to_bin[restype, state] -> bin, so prediction is one vectorized
    scatter-add over beads (the reference builds per-restype partition
    lists instead, py/predict_chi1.py:17-56 — same observable results,
    checked by tests/test_chi1.py)."""

    def __init__(self, sidechain_file):
        import h5py
        with h5py.File(sidechain_file, 'r') as t:
            restype_order = [b.decode() if isinstance(b, bytes) else str(b)
                             for b in t['restype_order']]
            self.restype_dict = {x: i for i, x in enumerate(restype_order)}
            self.n_restype = len(self.restype_dict)
            self.restype_dict['CPR'] = self.restype_dict['PRO']
            table = np.asarray(t['restype_and_chi_and_state'])

        rt = table[:, 0].astype(int)
        state = table[:, -1].astype(int)
        bins = compute_chi1_state(table[:, 1])
        self.n_state = int(state.max()) + 1
        self.state_to_bin = np.full((self.n_restype, self.n_state), -1,
                                    dtype=int)
        self.state_to_bin[rt, state] = bins
        # kept for API/debugging parity with the reference's partition view
        self.chi1_partition = {
            aa: [np.flatnonzero(self.state_to_bin[i] == j) for j in range(3)]
            for aa, i in self.restype_dict.items()}

    def predict_chi1(self, seq, residue, rotamer_posterior_prob):
        """seq: 3-letter sequence; residue: per-bead residue index (beads
        of one residue appear in library-state order); returns per-residue
        chi1-bin probabilities (n_res, 3)."""
        residue = np.asarray(residue)
        prob = np.asarray(rotamer_posterior_prob)
        res_rt = np.array([self.restype_dict[aa] for aa in seq])
        # per-bead library-state slot = rank within its residue
        first = np.concatenate([[0], np.flatnonzero(np.diff(residue)) + 1])
        slot = np.arange(len(residue)) - first[
            np.searchsorted(residue[first], residue)]
        bead_bin = self.state_to_bin[res_rt[residue], slot]

        out = np.zeros((len(seq), 3), dtype='f4')
        np.add.at(out, (residue, bead_bin), prob.astype('f4'))
        fixed = np.isin(np.asarray(seq), ('ALA', 'GLY'))
        out[fixed] = (1.0, 0.0, 0.0)
        return out

    def compute_zero_one_stats(self, seq, chi1_prob, chi1_states):
        rt = np.array([self.restype_dict[aa] for aa in seq])
        hit = (np.argmax(np.asarray(chi1_prob), axis=1) ==
               np.asarray(chi1_states)).astype('i8')
        results = np.zeros((self.n_restype, 2), dtype='i8')
        np.add.at(results[:, 0], rt, hit)
        np.add.at(results[:, 1], rt, 1)
        return results


def predict_chi1_from_pdb(pdb_text, sidechain_param,
                          chains: Optional[list] = None):
    """Full pipeline; returns (chi1_prob (n_res,3), seq, chi_true,
    elapsed_seconds)."""
    import tempfile

    import jax.numpy as jnp

    from .config.builder import ConfigBuilder
    from .config.reader import load_system
    from .io.pdb import extract_initial_structure

    info = extract_initial_structure(pdb_text, chains=chains,
                                     allow_unexpected_breaks=True)
    b = ConfigBuilder(f">x\n{info['fasta']}\n", initial_pos=info['coords'])
    # mirror the reference predict_chi1 config flags (predict_chi1.py:83-94):
    # no basic springs, no backbone sterics, loose hbond criteria,
    # dynamic rotamer 1-body, tiny hbond energy
    b.add_rotamer_sidechains(sidechain_param, sidechain_param, damping=0.4,
                             dynamic_1body=True)
    b.add_hbond(hbond_energy=-1e-5, loose=True,
                coverage_library=sidechain_param)
    b.add_rotamer_node()
    with tempfile.NamedTemporaryFile(suffix='.up') as f:
        b.write(f.name)
        system, params, pos, aux = load_system(f.name)
        sc = system.by_name['placement_fixed_point_vector_only']
        residue = np.asarray(sc.consts['affine_residue'])

    t0 = time.time()
    sens = np.asarray(system.get_sens(jnp.asarray(pos), params,
                                      'hbond_coverage'))[:, 0]
    elapsed = time.time() - t0

    predictor = Chi1Predict(sidechain_param)
    chi1_prob = predictor.predict_chi1(info['sequence'], residue, sens)
    return chi1_prob, info, elapsed


def main(argv=None):
    """predict_chi1 CLI (reference py/predict_chi1.py:60-130): reads a
    PDB, evaluates the loose-hbond prediction config once, and writes the
    per-residue chi1 rotamer-well probability table in the reference's
    column layout, printing the paper's evaluation-time metric."""
    import argparse

    p = argparse.ArgumentParser(
        prog="predict_chi1",
        description="chi1 rotamer-state prediction from a PDB structure")
    p.add_argument("pdb_input")
    p.add_argument("sidechain_param", help="sidechain parameter .h5")
    p.add_argument("chi_output", help="output table path")
    p.add_argument("--chains", default=None,
                   help="comma-separated chain ids to include")
    args = p.parse_args(argv)

    chains = args.chains.split(",") if args.chains else None
    with open(args.pdb_input) as f:
        pdb_text = f.read()
    chi1_prob, info, elapsed = predict_chi1_from_pdb(
        pdb_text, args.sidechain_param, chains=chains)

    seq = info["sequence"]
    print("Time to compute %.5f seconds for %i residues"
          % (elapsed, len(seq)))
    chi_true = np.asarray(info["chi"])
    chain_resnum = info["chain_resnum"]
    with open(args.chi_output, "w") as f:
        f.write("residue restype chain resnum chi1_prob0 chi1_prob1 "
                "chi1_prob2 chi1_from_input_file\n")
        for i in range(len(seq)):
            chain, resnum = chain_resnum[i]
            f.write("%i %s %s %s %.4f %.4f %.4f %.1f\n" % (
                i, ("PRO" if seq[i] == "CPR" else seq[i]), chain, resnum,
                chi1_prob[i, 0], chi1_prob[i, 1], chi1_prob[i, 2],
                chi_true[i, 0] / deg if np.isfinite(chi_true[i, 0])
                else -1.0))


if __name__ == "__main__":
    main()
