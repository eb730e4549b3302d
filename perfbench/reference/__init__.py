"""Plain references of the benchmark, one module per kind of model.

A reference module imports torch and numpy only: nothing of the system
under test, of the JAX package or of JAX. It works every derived array out
again from the raw inputs that ``perfbench.inputs`` makes.
"""
