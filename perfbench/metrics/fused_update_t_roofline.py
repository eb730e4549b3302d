"""``fused_update_t``'s share of its bytes bound in the traced slice
(kernels ``edge_t_kernel`` and ``edge_t_staged_kernel``)."""

from perfbench.roofline import kernel_share


def read(ctx):
    return kernel_share(ctx, r"\bedge_t(_staged)?_kernel\b")
