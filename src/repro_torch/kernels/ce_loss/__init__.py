from repro_torch.kernels.ce_loss.ops import ce_loss
from repro_torch.kernels.ce_loss.ref import ce_loss_ref

__all__ = ["ce_loss", "ce_loss_ref"]
