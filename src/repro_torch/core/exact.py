"""Exact inference oracles (host-side numpy): brute force + variable
elimination. Used for the paper's Fig-5 correctness test (KL-divergence of
BP marginals vs exact on Ising 10x10, C=2) and for unit tests. The port
keeps its own copy of ``repro.core.exact`` (numpy only), so its answers
are the reference's bit for bit.

Log-space throughout.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _logsumexp(a: np.ndarray, axis=None) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    out = np.log(np.sum(np.exp(a - m), axis=axis)) + np.squeeze(m, axis=axis)
    return out


def brute_force_marginals(n_vertices: int, edges: np.ndarray,
                          unary: Sequence[np.ndarray],
                          pairwise: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Enumerate the full joint. Only for tiny graphs (prod of states <~ 1e7)."""
    sizes = [len(u) for u in unary]
    total = int(np.prod(sizes))
    assert total <= 10_000_000, "graph too large for brute force"
    log_joint = np.zeros(sizes, dtype=np.float64)
    for v, u in enumerate(unary):
        shape = [1] * n_vertices
        shape[v] = sizes[v]
        log_joint = log_joint + np.log(np.asarray(u)).reshape(shape)
    for k, (i, j) in enumerate(np.asarray(edges)):
        i, j = int(i), int(j)
        table = np.log(np.asarray(pairwise[k], dtype=np.float64))
        reshaped = np.moveaxis(
            table.reshape([sizes[i], sizes[j]] + [1] * (n_vertices - 2)),
            [0, 1], [i, j])
        log_joint = log_joint + reshaped
    z = _logsumexp(log_joint.ravel(), axis=0)
    marginals = []
    for v in range(n_vertices):
        axes = tuple(a for a in range(n_vertices) if a != v)
        lm = _logsumexp(log_joint, axis=axes) - z
        marginals.append(np.exp(lm))
    return marginals


class _Factor:
    __slots__ = ("vars", "table")

    def __init__(self, vars_: Tuple[int, ...], table: np.ndarray):
        self.vars = tuple(vars_)
        self.table = table  # log-space, ndim == len(vars)

    def multiply(self, other: "_Factor") -> "_Factor":
        all_vars = tuple(sorted(set(self.vars) | set(other.vars)))
        def expand(f: "_Factor") -> np.ndarray:
            idx = [all_vars.index(v) for v in f.vars]
            t = f.table
            # move existing axes into sorted order, then insert size-1 axes
            order = np.argsort(idx)
            t = np.transpose(t, order)
            sorted_idx = [idx[o] for o in order]
            shape = [1] * len(all_vars)
            for pos, v in zip(sorted_idx, [f.vars[o] for o in order]):
                shape[pos] = f.table.shape[f.vars.index(v)]
            return t.reshape(shape)
        return _Factor(all_vars, expand(self) + expand(other))

    def eliminate(self, var: int) -> "_Factor":
        ax = self.vars.index(var)
        new_vars = tuple(v for v in self.vars if v != var)
        return _Factor(new_vars, _logsumexp(self.table, axis=ax))


def ve_marginals(n_vertices: int, edges: np.ndarray,
                 unary: Sequence[np.ndarray],
                 pairwise: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Per-vertex marginals via repeated min-degree variable elimination."""
    base: List[_Factor] = []
    for v, u in enumerate(unary):
        base.append(_Factor((v,), np.log(np.asarray(u, dtype=np.float64))))
    for k, (i, j) in enumerate(np.asarray(edges)):
        i, j = int(i), int(j)
        base.append(_Factor((i, j),
                            np.log(np.asarray(pairwise[k], dtype=np.float64))))

    marginals: List[np.ndarray] = []
    for q in range(n_vertices):
        factors = list(base)
        remaining = set(range(n_vertices)) - {q}
        while remaining:
            # greedy: eliminate the variable whose product factor is smallest
            def cost(v: int) -> int:
                size = 1
                seen = set()
                for f in factors:
                    if v in f.vars:
                        for w, s in zip(f.vars, f.table.shape):
                            if w not in seen:
                                seen.add(w)
                                size *= s
                return size
            v = min(remaining, key=cost)
            remaining.discard(v)
            involved = [f for f in factors if v in f.vars]
            factors = [f for f in factors if v not in f.vars]
            if involved:
                prod = involved[0]
                for f in involved[1:]:
                    prod = prod.multiply(f)
                factors.append(prod.eliminate(v))
        prod = factors[0]
        for f in factors[1:]:
            prod = prod.multiply(f)
        assert prod.vars == (q,)
        t = prod.table - _logsumexp(prod.table, axis=0)
        marginals.append(np.exp(t))
    return marginals


def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """KL(p || q) for two discrete distributions (paper Fig. 5 metric)."""
    p = np.clip(np.asarray(p, dtype=np.float64), eps, None)
    q = np.clip(np.asarray(q, dtype=np.float64), eps, None)
    p, q = p / p.sum(), q / q.sum()
    return float(np.sum(p * (np.log(p) - np.log(q))))
