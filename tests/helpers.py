"""Shared builders for synthetic test systems."""

import numpy as np

from upside_md.nodes.base import NodeSpec, resolve_node_type


def spec(name, args, consts=None, params=None):
    return NodeSpec(name=name, node_type=resolve_node_type(name),
                    args=args, consts=consts or {}, params=params or {})


def chain_positions(n_res, rng, noise=0.12):
    """Synthetic 3-atoms-per-residue (N, CA, C) extended chain with noise.

    Geometry roughly matches protein backbone bond lengths (in Angstroms)
    so that hbond/steric kernels see realistic distances.
    """
    pos = np.zeros((3 * n_res, 3))
    x = 0.0
    for r in range(n_res):
        base = np.array([x, 0.3 * (r % 2), 0.0])
        pos[3 * r + 0] = base
        pos[3 * r + 1] = base + [1.45, 0.45, 0.1]
        pos[3 * r + 2] = base + [2.4, 0.0, -0.1]
        x += 3.8
    pos += noise * rng.normal(size=pos.shape)
    return pos


def rama_coord_spec(n_res, name="rama_coord"):
    ids = np.zeros((n_res, 5), np.int32)
    dummy = np.zeros((n_res, 2), bool)
    for r in range(n_res):
        # prevC, N, CA, C, nextN
        ids[r] = [3 * r - 1, 3 * r, 3 * r + 1, 3 * r + 2, 3 * r + 3]
        if r == 0:
            dummy[r, 0] = True
            ids[r, 0] = 0
        if r == n_res - 1:
            dummy[r, 1] = True
            ids[r, 4] = 0
    return spec(name, ["pos"], {"id": ids, "dummy": dummy})


def affine_spec(n_res, rng, name="affine_alignment"):
    atoms = np.arange(3 * n_res, dtype=np.int32).reshape(n_res, 3)
    ref = np.array([[-1.2, -0.2, 0.0], [0.0, 0.5, 0.05], [1.2, -0.3, -0.05]])
    ref = ref - ref.mean(0)
    ref_geom = np.tile(ref, (n_res, 1, 1))
    return spec(name, ["pos"], {"atoms": atoms, "ref_geom": ref_geom})
