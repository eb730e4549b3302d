"""Graph generators of the benchmark, one module per configuration family.

Each module ``<generator>.py`` defines ``make(params, seed, slot) -> dict``
(``slot``: the graph's place in the run's pool) with the raw pairwise MRF
in linear space, as numpy arrays:

- ``n_vertices``: int;
- ``edges``: (E_und, 2) int64, undirected edge ``k`` joins
  ``edges[k, 0]`` and ``edges[k, 1]``;
- ``unary``: (V, S) float64, strictly positive;
- ``pairwise``: (E_und, S, S) float64 ``[x_i, x_j]``, strictly positive
  (a read-only broadcast view where every edge shares one table).

The same arrays go to the system under test and to the plain reference.
The modules import numpy only, so the yardstick cannot move with the
program.
"""
