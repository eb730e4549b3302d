"""Graph generators of the port (numpy-built, moved to a device once)."""

from repro_torch.pgm.datasets import (LDPCInstance, StereoInstance, WORKLOADS,
                                      chain_graph, get_workload, ising_grid,
                                      ising_grid_fast, ldpc_code, ldpc_graph,
                                      list_workloads, loop_graph,
                                      protein_like_graph, register_workload,
                                      small_ising, stereo_graph, stereo_mrf,
                                      zoo_stream)

__all__ = ["LDPCInstance", "StereoInstance", "WORKLOADS", "chain_graph",
           "get_workload", "ising_grid", "ising_grid_fast", "ldpc_code",
           "ldpc_graph", "list_workloads", "loop_graph",
           "protein_like_graph", "register_workload", "small_ising",
           "stereo_graph", "stereo_mrf", "zoo_stream"]
