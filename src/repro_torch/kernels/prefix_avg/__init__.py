from repro_torch.kernels.prefix_avg.ops import prefix_avg
from repro_torch.kernels.prefix_avg.ref import prefix_avg_ref

__all__ = ["prefix_avg", "prefix_avg_ref"]
