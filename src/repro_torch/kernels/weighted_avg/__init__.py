from repro_torch.kernels.weighted_avg.ops import weighted_avg
from repro_torch.kernels.weighted_avg.ref import weighted_avg_ref

__all__ = ["weighted_avg", "weighted_avg_ref"]
