from repro_torch.ft.resilience import StragglerMonitor, run_bp_resilient

__all__ = ["StragglerMonitor", "run_bp_resilient"]
