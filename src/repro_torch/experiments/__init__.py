"""The port's experiment scripts: the counterparts of the reference's
``experiments/*.py`` (``python -m repro_torch.experiments.<name>``)."""
