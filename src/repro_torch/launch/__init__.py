"""Launchers of the LM stack (a port of ``repro.launch``): ``serve`` and
``train``."""
