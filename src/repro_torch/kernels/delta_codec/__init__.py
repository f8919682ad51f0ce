from repro_torch.kernels.delta_codec.ops import delta_codec_roundtrip
from repro_torch.kernels.delta_codec.ref import delta_codec_ref

__all__ = ["delta_codec_roundtrip", "delta_codec_ref"]
