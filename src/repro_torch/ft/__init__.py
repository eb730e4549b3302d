from repro_torch.ft.resilience import (ElasticMesh, StragglerMonitor,
                                       run_bp_resilient)

__all__ = ["ElasticMesh", "StragglerMonitor", "run_bp_resilient"]
