from repro_torch.data.synth import SynthDataset, make_dataset

__all__ = ["SynthDataset", "make_dataset"]
