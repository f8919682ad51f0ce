from repro_torch.optim.sgd import SGDState, sgd_init, sgd_step
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_step

__all__ = [
    "SGDState", "sgd_init", "sgd_step",
    "AdamWState", "adamw_init", "adamw_step",
    "make_optimizer",
]


def make_optimizer(name: str, **kw):
    """Return (init_fn, step_fn) pair closing over hyperparameters (the
    reference's defaults)."""
    if name == "sgd":
        lr = kw.get("lr", 0.01)
        momentum = kw.get("momentum", 0.5)
        return (lambda p: sgd_init(p),
                lambda g, s, p: sgd_step(g, s, p, lr=lr, momentum=momentum))
    if name == "adamw":
        lr = kw.get("lr", 3e-4)
        return (lambda p: adamw_init(p),
                lambda g, s, p: adamw_step(g, s, p, lr=lr,
                                           b1=kw.get("b1", 0.9),
                                           b2=kw.get("b2", 0.95),
                                           eps=kw.get("eps", 1e-8),
                                           weight_decay=kw.get(
                                               "weight_decay", 0.0)))
    raise ValueError(f"unknown optimizer {name!r}")
