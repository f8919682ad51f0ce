"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the CUDA card; a CUDA device without a card raises.

    The port never drops to the CPU by itself: a caller that wants the CPU
    (the tests do) asks for it.  `meta` is accepted too: tensors with a
    shape and a dtype and no data, on which a dry run counts a step
    (`launch/dryrun.py`) without computing or allocating it.  Also turns TF32 off for matmuls and cuDNN
    convolutions, since the reference computes in full float32 and cuDNN
    convolutions default to TF32; and makes cuDNN pick deterministic
    convolution algorithms by its heuristics (no autotuning), so that two
    runs of one config, and the loop, batched and scan engines, compute
    the CNN's gradients bit for bit alike.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; options: 'cuda', "
                         f"'cpu', 'meta'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a host
    timer read after it counts the device's time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
