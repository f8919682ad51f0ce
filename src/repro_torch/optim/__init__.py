from repro_torch.optim.sgd import SGDState, sgd_init, sgd_step

__all__ = ["SGDState", "sgd_init", "sgd_step"]
