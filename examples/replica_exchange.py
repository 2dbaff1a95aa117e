#!/usr/bin/env python
"""Example: temperature replica exchange across a ladder of replicas.

    python examples/replica_exchange.py /tmp/rex --n-replica 8
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from upside_md.bench_systems import RAMA_REF, TRP_CAGE
from upside_md.config.builder import (ConfigBuilder,
                                          uniform_rama_maps_from_reference)
from upside_md.md.replica import even_odd_swap_sets
from upside_md.run import run_upside


def main():
    p = argparse.ArgumentParser()
    p.add_argument('workdir')
    p.add_argument('--n-replica', type=int, default=8)
    p.add_argument('--duration', type=float, default=27.0)
    p.add_argument('--hamiltonian', action='store_true',
                   help='per-slot Hamiltonian ladder (hbond-energy scale) '
                        'instead of identical configs; the CLI detects the '
                        'differing parameters and evaluates each slot under '
                        'its own Hamiltonian')
    args = p.parse_args()
    os.makedirs(args.workdir, exist_ok=True)

    configs = []
    for i in range(args.n_replica):
        b = ConfigBuilder(f'>x\n{TRP_CAGE}\n', seed=1)
        scale = 1.0 + (0.04 * i if args.hamiltonian else 0.0)
        b.add_backbone_springs()
        b.add_rama_map_pot(
            uniform_rama_maps_from_reference(b.n_res, RAMA_REF))
        b.add_backbone_pairs()
        b.add_hbond(hbond_energy=-2.1119 * scale)
        configs.append(b.write(os.path.join(args.workdir, f'rep{i}.up')))

    temps = 0.80 * (1.06 ** np.arange(args.n_replica))
    swap_sets = [','.join(f'{a}-{b}' for a, b in s)
                 for s in even_odd_swap_sets(args.n_replica)]
    run_upside(configs, duration=args.duration,
               frame_interval=max(args.duration / 50, 0.027),
               temperature=','.join(f'{t:.4f}' for t in temps),
               extra_args=[f'--swap-set={s}' for s in swap_sets] +
                          ['--replica-interval=0.27'])
    print('replica exchange finished; per-slot trajectories in', args.workdir)


if __name__ == '__main__':
    main()
