from repro_torch.kernels.cohort_gather.ops import cohort_gather, cohort_take
from repro_torch.kernels.cohort_gather.ref import cohort_gather_ref

__all__ = ["cohort_gather", "cohort_take", "cohort_gather_ref"]
