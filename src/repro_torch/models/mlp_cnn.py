"""The paper's task models: MLP (MNIST/FMNIST) and CNN (CIFAR10).

Counterpart of `repro/models/mlp_cnn.py`.  Functional: params are nested
dicts of tensors with the reference's keys and shapes, `apply(params, x)
-> logits`, `loss(params, x, y) -> scalar CE`.  The MLP keeps the
reference's (d_in, d_out) weight layout (`h @ w + b`); the CNN keeps NHWC
inputs and HWIO kernels at its public functions and converts inside.
`apply_batched` evaluates B models stacked on a leading axis of every leaf
on one shared input, the batch the Shapley utility scores.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

Params = Any


class ClassifierModel(NamedTuple):
    name: str
    init: Callable[[torch.Generator, torch.device], Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_batched: Callable[[Params, torch.Tensor], torch.Tensor]

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        return cross_entropy(self.apply(params, x), y)

    def accuracy(self, params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        logits = self.apply(params, x)
        return torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    return torch.mean(logz - gold)


def _dense_init(gen: torch.Generator, device, d_in: int, d_out: int,
                scale: float | None = None) -> dict:
    scale = scale if scale is not None else (2.0 / d_in) ** 0.5
    return {"w": torch.randn((d_in, d_out), generator=gen, device=device)
            * scale,
            "b": torch.zeros((d_out,), device=device)}


def make_mlp(input_dim: int = 784, hidden: Sequence[int] = (200, 100),
             n_classes: int = 10) -> ClassifierModel:
    dims = [input_dim, *hidden, n_classes]
    n_layers = len(dims) - 1

    def init(gen, device):
        return {f"layer{i}": _dense_init(gen, device, dims[i], dims[i + 1])
                for i in range(n_layers)}

    def apply(params, x):
        h = x.reshape(x.shape[0], -1)
        for i in range(n_layers):
            p = params[f"layer{i}"]
            h = h @ p["w"] + p["b"]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    def apply_batched(params, x):
        # (n, d) @ (B, d, k): the shared input broadcasts over the models
        h = x.reshape(x.shape[0], -1)
        for i in range(n_layers):
            p = params[f"layer{i}"]
            h = torch.matmul(h, p["w"]) + p["b"][:, None, :]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    return ClassifierModel("mlp", init, apply, apply_batched)


def make_cnn(input_shape=(32, 32, 3), n_classes: int = 10,
             channels: Sequence[int] = (32, 64),
             dense: int = 128) -> ClassifierModel:
    h, w, c_in = input_shape

    def init(gen, device):
        params = {}
        c_prev = c_in
        for i, c in enumerate(channels):
            fan_in = 3 * 3 * c_prev
            params[f"conv{i}"] = {
                "w": torch.randn((3, 3, c_prev, c), generator=gen,
                                 device=device) * (2.0 / fan_in) ** 0.5,
                "b": torch.zeros((c,), device=device),
            }
            c_prev = c
        hh, ww = h // (2 ** len(channels)), w // (2 ** len(channels))
        params["dense0"] = _dense_init(gen, device, hh * ww * c_prev, dense)
        params["head"] = _dense_init(gen, device, dense, n_classes)
        return params

    def apply(params, x):
        hcur = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for i in range(len(channels)):
            p = params[f"conv{i}"]
            hcur = F.conv2d(hcur, p["w"].permute(3, 2, 0, 1),  # HWIO -> OIHW
                            padding="same")
            hcur = torch.relu(hcur + p["b"][:, None, None])
            hcur = F.max_pool2d(hcur, 2, 2)
        # flatten in the reference's NHWC order
        hcur = hcur.permute(0, 2, 3, 1).reshape(hcur.shape[0], -1)
        hcur = torch.relu(hcur @ params["dense0"]["w"] + params["dense0"]["b"])
        return hcur @ params["head"]["w"] + params["head"]["b"]

    def apply_batched(params, x):
        n_models = params["head"]["b"].shape[0]
        return torch.stack([
            apply({k: {n: t[i] for n, t in v.items()}
                   for k, v in params.items()}, x)
            for i in range(n_models)])

    return ClassifierModel("cnn", init, apply, apply_batched)


@functools.lru_cache(maxsize=None)
def make_classifier(dataset: str) -> ClassifierModel:
    """The same dataset always yields the same model object."""
    if dataset in ("mnist", "fmnist"):
        return make_mlp()
    if dataset == "cifar10":
        return make_cnn()
    raise ValueError(f"no classifier for dataset {dataset!r}")
