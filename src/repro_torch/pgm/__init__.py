"""Graph generators of the port (numpy-built, moved to a device once)."""

from repro_torch.pgm.datasets import (chain_graph, ising_grid, ising_grid_fast,
                                      protein_like_graph, small_ising)

__all__ = ["chain_graph", "ising_grid", "ising_grid_fast",
           "protein_like_graph", "small_ising"]
