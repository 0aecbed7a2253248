"""repro_torch.core — the analytic performance models (the paper's §2/§4/§5
formulas).  The SPMD patterns and semantic oracles are a later slice."""

from repro_torch.core import analytics

__all__ = ["analytics"]
