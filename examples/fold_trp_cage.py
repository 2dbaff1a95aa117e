#!/usr/bin/env python
"""Example: constant-temperature MD of Trp-cage with the full forcefield.

Builds a .up config from sequence + the reference parameter libraries,
runs MD through the CLI driver, and exports the trajectory to PDB/VTF.

    python examples/fold_trp_cage.py /tmp/trpcage --duration 270
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from upside_md.bench_systems import (ENVIRONMENT, RAMA_REF, SIDECHAIN,
                                         TRP_CAGE, have_reference_params)
from upside_md.config.builder import (ConfigBuilder,
                                          uniform_rama_maps_from_reference)
from upside_md.io.trajectory import load_upside_traj, write_pdb, write_vtf
from upside_md.run import run_upside


def main():
    p = argparse.ArgumentParser()
    p.add_argument('workdir')
    p.add_argument('--duration', type=float, default=27.0)
    p.add_argument('--temperature', default='0.85')
    p.add_argument('--backbone-only', action='store_true')
    args = p.parse_args()
    os.makedirs(args.workdir, exist_ok=True)
    config = os.path.join(args.workdir, 'trpcage.up')

    b = ConfigBuilder(f'>trp-cage\n{TRP_CAGE}\n', seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(uniform_rama_maps_from_reference(b.n_res, RAMA_REF))
    b.add_backbone_pairs()
    if args.backbone_only or not have_reference_params():
        b.add_hbond(hbond_energy=-2.1119)
    else:
        b.add_rotamer_sidechains(SIDECHAIN, SIDECHAIN, damping=0.4,
                                 dynamic_1body=True)
        b.add_hbond(hbond_energy=-2.1119, coverage_library=SIDECHAIN)
        b.add_environment(ENVIRONMENT)
        b.add_rotamer_node()
    b.write(config)

    run_upside([config], duration=args.duration,
               frame_interval=max(args.duration / 100, 0.027),
               temperature=args.temperature,
               extra_args=['--monte-carlo-interval=0.27'])

    seq, time_, pos = load_upside_traj(config)
    write_pdb(os.path.join(args.workdir, 'traj.pdb'), seq, pos)
    write_vtf(os.path.join(args.workdir, 'traj.vtf'), seq, pos)
    print(f'wrote {len(pos)} frames to {args.workdir}/traj.pdb and .vtf')


if __name__ == '__main__':
    main()
