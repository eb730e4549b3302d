"""``fused_update_e``'s share of its bytes bound in the traced slice
(kernels ``edge_thread_kernel`` and ``edge_tile_kernel``)."""

from perfbench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, r"\bedge_(thread|tile)_kernel\b")
