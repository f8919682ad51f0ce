"""Plain PyTorch version of the delta_codec kernel (counterpart of
`repro/kernels/delta_codec/ref.py`): a rowwise encode -> decode on a
(rows, d) matrix, bitwise equal per row to `federated.compression`'s
per-leaf codecs.

  * quant8:      scale = max(max|x|, 1e-12) / 127 per row, then
                 clip(round(x / scale), -127, 127) * scale; round is half
                 to even, like `jnp.round`.  The divisor 127 is a tensor:
                 PyTorch on CUDA multiplies by a reciprocal when it divides
                 by a CPU scalar, which can differ in the last bit.
  * topk:        keep the k largest |x| per row, ties lowest column first
                 (a stable descending sort, the `lax.top_k` order); dropped
                 entries become +0.0 by `where`, never x * 0 (-0.0).
  * quant8_topk: the quant8 value on the top-k set; the row abs-max is the
                 scale, as the top-k set always holds the largest |x|.
"""
from __future__ import annotations

import torch

CODEC_IDS = {"quant8": 0, "topk": 1, "quant8_topk": 2}


def _quant8_rows(x: torch.Tensor) -> torch.Tensor:
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale


def _keep_mask(absx: torch.Tensor, k: int) -> torch.Tensor:
    """(rows, d) |x| -> boolean mask of exactly k entries per row."""
    order = torch.sort(absx, dim=-1, descending=True, stable=True).indices
    keep = torch.zeros(absx.shape, dtype=torch.bool, device=absx.device)
    return keep.scatter_(-1, order[:, :k], True)


def delta_codec_ref(x: torch.Tensor, codec: str, k: int = 0) -> torch.Tensor:
    """Roundtrip (encode -> decode) each row of x (rows, d) through codec."""
    if codec not in CODEC_IDS:
        raise ValueError(f"unknown delta codec {codec!r}")
    orig = x.dtype
    x = x.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if codec == "quant8":
        out = _quant8_rows(x)
    elif codec == "topk":
        out = torch.where(_keep_mask(torch.abs(x), k), x, zero)
    else:
        out = torch.where(_keep_mask(torch.abs(x), k), _quant8_rows(x), zero)
    return out.to(orig)
