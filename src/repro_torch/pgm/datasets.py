"""Benchmark PGM generators (paper SS III-C, SS IV-C, SS IV-E), numpy-built.

The port of ``repro.pgm.datasets``. Each
draws its potentials with numpy exactly as the reference does, so the same
seed gives bitwise-equal arrays, and hands them to the port's builders,
which move the finished graph to ``device`` (default ``"cuda"``).

Ising grids: N x N binary variables. Unary psi_i ~ U[0,1] (per-state
sample). Pairwise: psi_ij = e^{lambda C} if x_i == x_j else e^{-lambda C},
with lambda ~ U[-0.5, 0.5] per edge; C controls difficulty (paper uses C in
{2, 2.5, 3}).

Chains: N binary variables in a path; same potential sampling, C = 10 in
the paper -- BP is exact there, which exposes scheduler *overhead*.

Protein-like graphs (SS IV-E): structurally matched stand-ins for the
side-chain prediction MRFs -- random geometric contact graphs with 2..81
states per vertex and dense positive pairwise tables.

The workload zoo: loops, LDPC decoding (``ldpc_code``: each parity check
is an auxiliary vertex whose states enumerate its even-parity member
assignments) and a stereo-vision MRF (``stereo_mrf``: truncated-linear
data and smoothness terms on a pixel grid). ``WORKLOADS`` names every zoo
member and ``zoo_stream`` interleaves them at mixed kinds and sizes. Every
generator takes ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import PGM, build_pgm, build_pgm_uniform
from repro_torch.core.registry import Registry

__all__ = [
    "LDPCInstance", "StereoInstance", "WORKLOADS", "chain_graph",
    "get_workload", "ising_grid", "ising_grid_fast", "ldpc_code",
    "ldpc_graph", "list_workloads", "loop_graph", "protein_like_graph",
    "register_workload", "small_ising", "stereo_graph", "stereo_mrf",
    "zoo_stream",
]


def _grid_edges(n: int) -> np.ndarray:
    """Vectorized N x N grid edge list."""
    idx = np.arange(n * n).reshape(n, n)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([horiz, vert], axis=0)


def _loop_grid_edges(n: int) -> np.ndarray:
    """N x N grid edges in the reference's per-vertex loop order."""
    v = lambda r, c: r * n + c
    edges = []
    for r in range(n):
        for c in range(n):
            if c + 1 < n:
                edges.append((v(r, c), v(r, c + 1)))
            if r + 1 < n:
                edges.append((v(r, c), v(r + 1, c)))
    return np.array(edges, dtype=np.int64)


def _ising_potentials(rng: np.random.Generator, n_edges: int, C: float
                      ) -> List[np.ndarray]:
    lam = rng.uniform(-0.5, 0.5, size=n_edges)
    agree = np.exp(lam * C)
    disagree = np.exp(-lam * C)
    return [np.array([[a, d], [d, a]]) for a, d in zip(agree, disagree)]


def ising_grid_fast(n: int, C: float, seed: int = 0, *,
                    device="cuda") -> PGM:
    """Vectorized N x N Ising grid (the same distribution family as
    ``ising_grid``, a different edge order and draw sequence); the builder
    for large grids, where a per-edge Python loop is prohibitive."""
    rng = np.random.default_rng(seed)
    edges = _grid_edges(n)
    unary = rng.uniform(1e-3, 1.0, size=(n * n, 2))
    lam = rng.uniform(-0.5, 0.5, size=len(edges))
    agree, disagree = np.exp(lam * C), np.exp(-lam * C)
    pairwise = np.empty((len(edges), 2, 2))
    pairwise[:, 0, 0] = pairwise[:, 1, 1] = agree
    pairwise[:, 0, 1] = pairwise[:, 1, 0] = disagree
    return build_pgm_uniform(n * n, edges, unary, pairwise, device=device)


def ising_grid(n: int, C: float, seed: int = 0, *, device="cuda") -> PGM:
    """N x N Ising grid, paper SS III-C: uniform [0,1] unaries and
    agree/disagree pairwise tables at coupling strength ``C``."""
    rng = np.random.default_rng(seed)
    edges = _loop_grid_edges(n)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n * n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    return build_pgm(n * n, edges, unary, pairwise, device=device)


def small_ising(n: int = 10, C: float = 2.0, seed: int = 0, *,
                device="cuda") -> Tuple[PGM, int, np.ndarray, list, list]:
    """Ising grid plus raw ``(n_vertices, edges, unary, pairwise)`` for an
    exact oracle (paper Fig 5 uses 10x10, C=2)."""
    rng = np.random.default_rng(seed)
    edges = _loop_grid_edges(n)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n * n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    pgm = build_pgm(n * n, edges, unary, pairwise, device=device)
    return pgm, n * n, edges, unary, pairwise


def chain_graph(n: int, C: float = 10.0, seed: int = 0, *,
                device="cuda") -> PGM:
    """Length-n binary chain, paper SS III-C (n = 100000, C = 10)."""
    rng = np.random.default_rng(seed)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    return build_pgm(n, edges, unary, pairwise, device=device)


def loop_graph(n: int, C: float = 2.0, seed: int = 0, *,
               device="cuda") -> PGM:
    """Length-n binary cycle (single loop): the minimal loopy graph, a
    cheap mixed-batch member with a third structure class."""
    rng = np.random.default_rng(seed)
    edges = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    unary = [rng.uniform(1e-3, 1.0, size=2) for _ in range(n)]
    pairwise = _ising_potentials(rng, len(edges), C)
    return build_pgm(n, edges, unary, pairwise, device=device)


def protein_like_graph(n_vertices: int = 120, seed: int = 0, *,
                       max_states: int = 81, coupling: float = 2.0,
                       radius: float = 0.14, device="cuda") -> PGM:
    """Irregular mixed-cardinality MRF shaped like side-chain prediction
    problems (paper SS IV-E): spatial contact graph, 2..max_states states,
    pairwise tables exp(coupling * U(-1, 1))."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, size=(n_vertices, 2))
    edges = []
    for i in range(n_vertices):
        for j in range(i + 1, n_vertices):
            if np.linalg.norm(pos[i] - pos[j]) < radius:
                edges.append((i, j))
    # ensure connectivity along a backbone (residue chain)
    for i in range(n_vertices - 1):
        if (i, i + 1) not in edges:
            edges.append((i, i + 1))
    edges = np.array(sorted(set(map(tuple, edges))), dtype=np.int64)
    # state counts: skewed toward small, ranging 2..max_states (paper: 2..81)
    n_states = np.clip(
        rng.geometric(p=0.08, size=n_vertices) + 1, 2, max_states)
    unary = [rng.uniform(1e-2, 1.0, size=int(s)) for s in n_states]
    pairwise = []
    for (i, j) in edges:
        si, sj = int(n_states[i]), int(n_states[j])
        pairwise.append(np.exp(coupling * rng.uniform(-1.0, 1.0, (si, sj))))
    return build_pgm(n_vertices, edges, unary, pairwise, device=device)


# ------------------------------------------------------------------ LDPC --

def _gallager_checks(rng: np.random.Generator, n: int, dv: int, dc: int
                     ) -> List[Tuple[int, ...]]:
    """Regular Gallager construction: the n*dv bit sockets are permuted into
    m = n*dv/dc checks of dc sockets each; duplicate memberships within a
    check are repaired by deterministic socket swaps (seeded ``rng``), so
    every check touches dc *distinct* bits."""
    if (n * dv) % dc:
        raise ValueError(f"n*dv={n * dv} must divide by dc={dc}")
    m = n * dv // dc
    checks = rng.permutation(np.repeat(np.arange(n), dv)).reshape(m, dc)
    for _ in range(100 * n * dv):
        dup = None
        for c in range(m):
            vals, cnt = np.unique(checks[c], return_counts=True)
            if np.any(cnt > 1):
                dup = (c, int(vals[cnt > 1][0]))
                break
        if dup is None:
            return [tuple(sorted(int(b) for b in row)) for row in checks]
        c, v = dup
        k = int(np.where(checks[c] == v)[0][0])
        c2, k2 = int(rng.integers(m)), int(rng.integers(dc))
        checks[c, k], checks[c2, k2] = checks[c2, k2], checks[c, k]
    raise ValueError(
        f"could not repair duplicate sockets for (n={n}, dv={dv}, dc={dc})")


@dataclasses.dataclass(frozen=True)
class LDPCInstance:
    """One simulated LDPC transmission: the decoder PGM plus everything the
    exact oracles and BER accounting need.

    The all-zero codeword is BPSK-modulated (bit 0 -> +1) over an AWGN
    channel at ``snr_db``; ``y`` are the received samples, ``llr`` the
    channel log-likelihood ratios. Bits are the first ``n_bits`` vertices
    (2 states); each parity check is an auxiliary vertex whose states
    enumerate its even-parity member assignments, tied to each member bit
    by a smoothed indicator table. Decode with the max-product backend and
    read bit ``i`` from ``map_assignment(...)[:n_bits]``."""

    pgm: PGM
    n_bits: int
    checks: Tuple[Tuple[int, ...], ...]
    y: np.ndarray                       # (n_bits,) received samples
    llr: np.ndarray                     # (n_bits,) channel LLRs (clipped)
    sigma: float
    snr_db: float
    edges: np.ndarray                   # (E, 2) bit -> check-aux
    unary: Tuple[np.ndarray, ...]
    pairwise: Tuple[np.ndarray, ...]

    @property
    def n_vertices(self) -> int:
        """Total vertex count: ``n_bits`` bits + one auxiliary per check."""
        return self.n_bits + len(self.checks)

    def raw(self):
        """``(n_vertices, edges, unary, pairwise)`` for the exact oracles
        (``brute_force_marginals`` / ``ve_marginals``)."""
        return (self.n_vertices, [tuple(e) for e in self.edges],
                list(self.unary), list(self.pairwise))

    @property
    def uncoded_errors(self) -> int:
        """Hard-decision bit errors on the raw channel samples -- the
        uncoded baseline a decoder must beat."""
        return int(np.sum(self.y < 0))

    def coded_errors(self, decoded_bits: np.ndarray) -> int:
        """Bit errors of a decoded assignment vs the all-zero codeword."""
        return int(np.sum(np.asarray(decoded_bits)[: self.n_bits] != 0))


def ldpc_code(n: int = 48, *, dv: int = 3, dc: int = 6, snr_db: float = 2.0,
              seed: int = 0, check_eps: float = 1e-6,
              llr_clip: float = 25.0, device="cuda") -> LDPCInstance:
    """Simulate one (n, dv, dc)-regular LDPC transmission as a decoder PGM.

    The all-zero codeword (valid for every parity-check code) is sent as
    BPSK +1 over AWGN with ``sigma**2 = 1 / (2 * 10**(snr_db/10))``; bit
    unaries are ``exp(+-llr/2)`` with exponents clipped to ``llr_clip``.
    Each check's auxiliary vertex has ``2**(dc-1)`` even-parity states; the
    table tying it to its k-th member bit is 1.0 where the state agrees
    with the bit and ``check_eps`` elsewhere (``build_pgm`` requires
    strictly positive potentials, so the indicator is smoothed)."""
    rng = np.random.default_rng(seed)
    checks = _gallager_checks(rng, n, dv, dc)
    m = len(checks)
    snr = 10.0 ** (snr_db / 10.0)
    sigma = float(np.sqrt(1.0 / (2.0 * snr)))
    y = 1.0 + sigma * rng.normal(size=n)
    llr = np.clip(2.0 * y / sigma ** 2, -2.0 * llr_clip, 2.0 * llr_clip)
    unary = [np.exp(np.clip(np.array([l / 2.0, -l / 2.0]), -llr_clip,
                            llr_clip)) for l in llr]
    configs = np.array([c for c in itertools.product((0, 1), repeat=dc)
                        if sum(c) % 2 == 0])                # (2**(dc-1), dc)
    n_cfg = len(configs)
    unary += [np.ones(n_cfg) for _ in range(m)]
    edges, pairwise = [], []
    for c, members in enumerate(checks):
        for k, b in enumerate(members):
            edges.append((b, n + c))
            table = np.full((2, n_cfg), check_eps)
            table[configs[:, k], np.arange(n_cfg)] = 1.0
            pairwise.append(table)
    edges = np.array(edges, dtype=np.int64)
    pgm = build_pgm(n + m, edges, unary, pairwise, device=device)
    return LDPCInstance(pgm=pgm, n_bits=n, checks=tuple(checks),
                        y=y, llr=llr, sigma=sigma, snr_db=snr_db,
                        edges=edges, unary=tuple(unary),
                        pairwise=tuple(pairwise))


def ldpc_graph(seed: int = 0, *, n: int = 48, dv: int = 3, dc: int = 6,
               snr_db: float = 2.0, device="cuda", **kwargs) -> PGM:
    """PGM-only view of :func:`ldpc_code` -- the zoo entry point (one
    fresh noise realization and code per ``seed``)."""
    return ldpc_code(n, dv=dv, dc=dc, snr_db=snr_db, seed=seed,
                     device=device, **kwargs).pgm


# ---------------------------------------------------------------- stereo --

def _grid_edges_rect(height: int, width: int) -> np.ndarray:
    """Vectorized height x width grid edge list (4-neighborhood)."""
    idx = np.arange(height * width).reshape(height, width)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([horiz, vert], axis=0)


@dataclasses.dataclass(frozen=True)
class StereoInstance:
    """One synthetic stereo-matching MRF: the grid PGM plus the scene.

    ``truth`` is the ground-truth disparity map (a slanted background plane
    with a raised foreground rectangle), ``obs`` the noisy per-pixel
    disparity observation (Gaussian noise plus uniform outliers). Vertices
    are pixels in row-major order with ``n_disp`` states; decode with
    max-product and score via :meth:`accuracy` / :meth:`energy`."""

    pgm: PGM
    height: int
    width: int
    n_disp: int
    truth: np.ndarray                   # (H, W) int ground-truth disparity
    obs: np.ndarray                     # (H, W) float noisy observation
    edges: np.ndarray                   # (E, 2) grid edges
    unary: np.ndarray                   # (H*W, n_disp)
    pairwise: np.ndarray                # (E, n_disp, n_disp)

    def raw(self):
        """``(n_vertices, edges, unary, pairwise)`` for the exact oracles."""
        n = self.height * self.width
        return (n, [tuple(e) for e in self.edges],
                [self.unary[i] for i in range(n)],
                [self.pairwise[k] for k in range(len(self.edges))])

    def energy(self, labels: np.ndarray) -> float:
        """Negative log-potential of a disparity labeling (lower is better);
        the MAP objective max-product minimizes."""
        lbl = np.asarray(labels).reshape(-1)[: self.height * self.width]
        e = -float(np.sum(np.log(self.unary[np.arange(lbl.size), lbl])))
        e -= float(np.sum(np.log(
            self.pairwise[np.arange(len(self.edges)),
                          lbl[self.edges[:, 0]], lbl[self.edges[:, 1]]])))
        return e

    def accuracy(self, labels: np.ndarray, slack: int = 1) -> float:
        """Fraction of pixels whose decoded disparity is within ``slack``
        of ground truth (the standard stereo bad-pixel metric's complement)."""
        lbl = np.asarray(labels).reshape(-1)[: self.height * self.width]
        return float(np.mean(
            np.abs(lbl - self.truth.reshape(-1)) <= slack))


def stereo_mrf(height: int = 12, width: int = 16, n_disp: int = 8, *,
               seed: int = 0, noise: float = 0.6, outlier_frac: float = 0.05,
               lam_data: float = 1.0, trunc_data: float = 2.0,
               lam_smooth: float = 0.55,
               trunc_smooth: float = 2.0, device="cuda") -> StereoInstance:
    """Synthetic stereo-vision MRF: truncated-linear data + smoothness.

    The scene is a disparity ramp (a slanted background plane) with a
    raised foreground rectangle; observations add Gaussian noise and a
    fraction of uniform outliers. Potentials are the classic stereo energy:
    ``exp(-lam_data * min(|d - obs|, trunc_data))`` unaries and
    ``exp(-lam_smooth * min(|d_i - d_j|, trunc_smooth))`` pairwise terms
    (truncated-linear smoothness preserves disparity edges). Row-major
    pixel order keeps the grid's band structure contiguous."""
    rng = np.random.default_rng(seed)
    _, cc = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    truth = np.clip(np.round((cc / max(width - 1, 1)) * (n_disp // 2)),
                    0, n_disp - 1).astype(int)
    fh, fw = max(1, height // 3), max(1, width // 3)
    r0, c0 = height // 4, width // 4
    truth[r0:r0 + fh, c0:c0 + fw] = max(n_disp - 2, 0)
    obs = truth + rng.normal(0.0, noise, truth.shape)
    outliers = rng.random(truth.shape) < outlier_frac
    obs[outliers] = rng.integers(0, n_disp, int(outliers.sum()))
    d = np.arange(n_disp)
    unary = np.exp(-lam_data * np.minimum(
        np.abs(obs.reshape(-1, 1) - d), trunc_data))
    edges = _grid_edges_rect(height, width)
    smooth = np.exp(-lam_smooth * np.minimum(
        np.abs(d[:, None] - d[None, :]), trunc_smooth))
    pairwise = np.broadcast_to(
        smooth, (len(edges), n_disp, n_disp)).copy()
    pgm = build_pgm_uniform(height * width, edges, unary, pairwise,
                            device=device)
    return StereoInstance(pgm=pgm, height=height, width=width, n_disp=n_disp,
                          truth=truth, obs=obs, edges=edges, unary=unary,
                          pairwise=pairwise)


def stereo_graph(seed: int = 0, *, height: int = 12, width: int = 16,
                 n_disp: int = 8, **kwargs) -> PGM:
    """PGM-only view of :func:`stereo_mrf` -- the zoo entry point (one
    fresh scene realization per ``seed``)."""
    return stereo_mrf(height, width, n_disp, seed=seed, **kwargs).pgm


# ----------------------------------------------------- workload registry --

#: name -> ``fn(seed=0, *, device="cuda", **size_kwargs) -> PGM`` zoo
#: generator. A ``Registry`` (dict subclass), the same family pattern as
#: schedulers and update backends.
WORKLOADS: Registry = Registry("workload", {})


def register_workload(name: str, *, overwrite: bool = False):
    """Decorator registering a zoo generator under ``name`` (lowercased).
    Generators take ``seed`` plus size kwargs and return a ``PGM``;
    duplicates raise ``ValueError`` unless ``overwrite=True``."""
    return WORKLOADS.register(name, overwrite=overwrite)


def list_workloads() -> List[str]:
    """Sorted registered workload names (valid ``get_workload`` specs)."""
    return WORKLOADS.names()


def get_workload(name: str):
    """Resolve a workload name to its registered generator function."""
    return WORKLOADS.lookup(name)


@register_workload("ising")
def _ising_workload(seed: int = 0, *, n: int = 10, C: float = 2.0,
                    device="cuda") -> PGM:
    """N x N Ising grid zoo member (paper SS III-C potentials)."""
    return ising_grid(n, C, seed=seed, device=device)


@register_workload("chain")
def _chain_workload(seed: int = 0, *, n: int = 300, C: float = 10.0,
                    device="cuda") -> PGM:
    """Binary-chain zoo member: BP-exact, exposes scheduler overhead."""
    return chain_graph(n, C, seed=seed, device=device)


@register_workload("protein")
def _protein_workload(seed: int = 0, *, n_vertices: int = 40,
                      device="cuda") -> PGM:
    """Protein-like mixed-cardinality zoo member (2..81 states)."""
    return protein_like_graph(n_vertices, seed=seed, device=device)


@register_workload("ldpc")
def _ldpc_workload(seed: int = 0, *, n: int = 48, dv: int = 3, dc: int = 6,
                   snr_db: float = 2.0, device="cuda") -> PGM:
    """LDPC decoding zoo member: one fresh AWGN transmission per seed."""
    return ldpc_graph(seed, n=n, dv=dv, dc=dc, snr_db=snr_db, device=device)


@register_workload("stereo")
def _stereo_workload(seed: int = 0, *, height: int = 12, width: int = 16,
                     n_disp: int = 8, device="cuda") -> PGM:
    """Stereo-vision grid-MRF zoo member: one fresh scene per seed."""
    return stereo_graph(seed, height=height, width=width, n_disp=n_disp,
                        device=device)


#: ``zoo_stream``'s interleave table: (kind, size kwargs) per slot. Two
#: size variants per kind, so a stream mixes shapes *within* each kind too
#: -- the bucketing/admission stressor.
_ZOO_VARIANTS: Tuple[Tuple[str, dict], ...] = (
    ("ising", dict(n=6, C=2.0)),
    ("chain", dict(n=120)),
    ("ldpc", dict(n=24, dv=2, dc=4)),
    ("stereo", dict(height=6, width=8, n_disp=4)),
    ("protein", dict(n_vertices=24)),
    ("ising", dict(n=10, C=2.5)),
    ("chain", dict(n=300)),
    ("ldpc", dict(n=48, dv=3, dc=6)),
    ("stereo", dict(height=8, width=10, n_disp=5)),
)


def zoo_stream(n: int, *, seed: int = 0,
               kinds: Sequence[str] | None = None,
               slos: "float | Mapping[str, float] | None" = None,
               device="cuda") -> Iterator[tuple]:
    """Yield ``n`` heterogeneous ``(kind, PGM)`` requests cycling the zoo.

    Kinds *and* sizes interleave (two size variants per kind, see
    ``_ZOO_VARIANTS``), so consecutive requests rarely share a bucket shape
    -- the scenario the admission and kind_affinity routing policies exist
    for. Deterministic: request ``i`` is generated with seed
    ``1000 * seed + i``, so two streams with equal ``(n, seed, kinds)``
    are identical graph for graph. ``kinds`` filters the table to a
    subset (unknown names raise ``KeyError`` via the registry).

    ``slos`` attaches per-request latency budgets: a float applies one
    budget to everything, a mapping sets one per kind (missing kinds get
    no deadline). Items then come as ``(kind, PGM, slo_s)`` triples.
    ``device`` is where every graph is built."""
    variants = _ZOO_VARIANTS
    if kinds is not None:
        for k in kinds:
            WORKLOADS.lookup(k)        # fail fast on unknown kinds
        variants = tuple((k, kw) for k, kw in _ZOO_VARIANTS if k in kinds)
        if not variants:
            raise ValueError(f"no zoo variants left after filtering {kinds}")
    for i in range(n):
        kind, kw = variants[i % len(variants)]
        pgm = WORKLOADS[kind](seed=1000 * seed + i, device=device, **kw)
        if slos is None:
            yield kind, pgm
        elif isinstance(slos, Mapping):
            yield kind, pgm, slos.get(kind)
        else:
            yield kind, pgm, float(slos)
