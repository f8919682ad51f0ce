from repro_torch.models.mlp_cnn import (
    ClassifierModel, make_classifier, make_cnn, make_mlp,
)

__all__ = ["ClassifierModel", "make_mlp", "make_cnn", "make_classifier"]
