"""System: a compiled computation graph producing a scalar potential.

Replaces the reference DerivEngine (src/deriv_engine.cpp:94-192).  A System
holds a topologically-ordered list of NodeSpecs; `energy` traces every node
into one jittable function of (pos, params).  Forces are `-jax.grad`;
per-node parameter derivatives are jax.grad w.r.t. the params pytree; node
output cotangents ("sens" in the reference, e.g. the chi1-prediction path
reading hbond_coverage sensitivities, py/predict_chi1.py:105) come from
grad w.r.t. zero-valued injections added to each node output.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .nodes.base import NodeSpec, topo_sort


class System:
    def __init__(self, n_atom: int, specs: List[NodeSpec]):
        self.n_atom = n_atom
        by_name = {s.name: s for s in specs}
        if len(by_name) != len(specs):
            raise ValueError("duplicate node names")
        self.specs = topo_sort(by_name)
        self.by_name = {s.name: s for s in self.specs}

    # -- parameters ---------------------------------------------------------

    def make_params(self) -> Dict[str, Dict]:
        """The differentiable parameter pytree {node_name: {param: array}}."""
        return {s.name: {k: jnp.asarray(v) for k, v in s.params.items()}
                for s in self.specs if s.params}

    # -- graph evaluation ----------------------------------------------------

    def evaluate(self, pos, params, inject: Optional[Dict] = None,
                 extra: Optional[Dict] = None, cache: Optional[Dict] = None):
        """Run the graph.  Returns (total_potential, outputs, per_term).

        inject: optional {node_name: array} added to that node's output —
        used to extract output cotangents (reference 'sens') via jax.grad.
        extra:  step-dependent scalars (e.g. {'time': t} for the AFM node).
        cache:  optional {node_name: pytree} of per-step solver state
        (e.g. warm-start BP messages); nodes write their updated state into
        extra['_cache_out'], which evaluate installs and the caller reads
        back through energy_and_cache.
        """
        extra = dict(extra) if extra else {}
        extra["_cache"] = cache or {}
        extra.setdefault("_cache_out", {})
        outputs = {"pos": pos}
        per_term = {}
        for s in self.specs:
            inputs = [outputs[a] for a in s.args]
            p = params.get(s.name, {})
            extra["_node_name"] = s.name
            out = s.node_type.compute(s.consts, p, inputs, extra)
            if s.node_type.is_potential:
                per_term[s.name] = out
            else:
                if inject is not None and s.name in inject:
                    out = out + inject[s.name]
                outputs[s.name] = out
        total = jnp.asarray(0.0, dtype=pos.dtype)
        for v in per_term.values():
            total = total + v
        return total, outputs, per_term

    def energy(self, pos, params, extra: Optional[Dict] = None):
        return self.evaluate(pos, params, extra=extra)[0]

    # -- per-step solver state (warm starts) ---------------------------------

    def init_cache(self) -> Dict:
        """Initial per-node solver state for energy_and_cache (e.g. BP
        warm-start messages).  Empty for graphs with no iterative nodes."""
        cache = {}
        for s in self.specs:
            if s.node_type.init_cache is not None:
                c0 = s.node_type.init_cache(s.consts, s.params)
                if c0 is not None:
                    cache[s.name] = c0
        return cache

    def energy_and_cache(self, pos, params, extra: Optional[Dict] = None,
                         cache: Optional[Dict] = None):
        """Like energy, but threads per-node solver state: takes the
        previous step's cache and returns (energy, new_cache).  Warm
        starts only change solver iteration counts, never converged
        answers beyond tolerances, so grad-of-energy stays the physical
        force.  The returned cache is stop_gradient'd by the nodes."""
        extra = dict(extra) if extra else {}
        cache_out: Dict = {}
        extra["_cache_out"] = cache_out
        total, _, _ = self.evaluate(pos, params, extra=extra, cache=cache)
        # keep the cache pytree structure stable even if a node skipped
        # writing (it must not, but a stable carry is worth the guard)
        if cache:
            for k, v in cache.items():
                cache_out.setdefault(k, v)
        return total, cache_out

    def deriv(self, pos, params):
        """d(potential)/d(pos) — the reference calls this 'deriv'; force is
        its negation."""
        return jax.grad(self.energy)(pos, params)

    def get_output(self, pos, params, name):
        return self.evaluate(pos, params)[1][name]

    def get_sens(self, pos, params, name):
        """Cotangent of the total potential w.r.t. node `name`'s output."""
        out_shape = self.get_output(pos, params, name)

        def f(z):
            return self.evaluate(pos, params, inject={name: z})[0]

        return jax.grad(f)(jnp.zeros_like(out_shape))

    def param_deriv(self, pos, params, name):
        """Gradient of total potential w.r.t. node `name`'s params."""
        def f(p_node):
            p = dict(params)
            p[name] = p_node
            return self.energy(pos, p)

        return jax.grad(f)(params[name])


def build_system(n_atom: int, specs: List[NodeSpec]) -> System:
    return System(n_atom, specs)


def freeze_static_nodes(system: System, params):
    """Constant-fold coordinate nodes that do not depend on `pos`
    (reference upside_engine.freeze_nodes, py/upside_engine.py:251-277).

    Returns (frozen_system, frozen_params).  Under jit XLA constant-folds
    these anyway; this utility exists for API parity and for shrinking
    graphs before compilation."""
    from .nodes.base import resolve_node_type

    depends = {"pos"}
    for s in system.specs:
        if any(a in depends for a in s.args):
            depends.add(s.name)

    zero_pos = jnp.zeros((system.n_atom, 3), jnp.float32)
    _, outputs, _ = system.evaluate(zero_pos, params)

    new_specs = []
    new_params = {}
    for s in system.specs:
        if s.name in depends or s.node_type.is_potential:
            new_specs.append(s)
            if s.name in params:
                new_params[s.name] = params[s.name]
        else:
            frozen_value = {"value": jnp.asarray(outputs[s.name])}
            new_specs.append(NodeSpec(
                name=s.name, node_type=resolve_node_type("constant"),
                args=[], consts={}, params=frozen_value))
            new_params[s.name] = frozen_value
    return System(system.n_atom, new_specs), new_params
