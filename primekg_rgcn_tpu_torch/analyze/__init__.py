from primekg_rgcn_tpu_torch.analyze.core import AnalysisContext

__all__ = ["AnalysisContext"]
