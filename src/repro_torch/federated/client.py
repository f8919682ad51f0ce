"""ClientUpdate (Alg. 1 line 7) — local training at a selected client.

Counterpart of `repro/federated/client.py`: E_k x B SGD-momentum steps
(eta=0.01, gamma=0.5) on minibatches drawn by index from the client's
valid prefix, the FedProx term mu/2 ||w - w^t||^2, and N(0, sigma_k^2)
privacy noise on the uploaded parameters.  Gradients come from
`torch.autograd` on the functional model.  The minibatch index table and
the noise leaves are inputs (see `federated/draws.py`): the index table is
always drawn at the full E*B size, even for a straggler that runs fewer
steps, as the reference does.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.aggregation import tree_sq_norm, tree_sub
from repro_torch.models.mlp_cnn import ClassifierModel
from repro_torch.optim.sgd import sgd_init, sgd_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


class ClientConfig(NamedTuple):
    epochs: int = 5            # E
    batches_per_epoch: int = 5 # B
    batch_size: int = 32
    lr: float = 0.01           # eta
    momentum: float = 0.5      # gamma
    prox_mu: float = 0.0       # FedProx mu (0 => FedAvg-style update)


def make_local_loss(model: ClassifierModel, cfg: ClientConfig,
                    params0: Params):
    """The client's training loss (p, xb, yb) -> scalar: the model's loss on
    the minibatch plus the FedProx term mu/2 ||p - params0||^2."""
    def local_loss_fn(p, xb, yb):
        loss = model.loss(p, xb, yb)
        if cfg.prox_mu > 0.0:
            loss = loss + 0.5 * cfg.prox_mu * tree_sq_norm(tree_sub(p, params0))
        return loss

    return local_loss_fn


def client_update(model: ClassifierModel, cfg: ClientConfig, params0: Params,
                  x: torch.Tensor, y: torch.Tensor, epochs_k: int,
                  sigma_k: float, idx: torch.Tensor,
                  noise: Sequence[torch.Tensor]) -> Params:
    """Run epochs_k * B SGD-momentum steps from params0; return the noisy
    w_k^{t+1}.

    x (capacity, ...) / y (capacity,): the client's padded data;
    idx (E*B, batch) int64: minibatch rows, drawn in [0, max(n_valid, 1));
    noise: standard-normal leaves in `tree_leaves` order.
    """
    params0 = tree_map(lambda p: p.detach(), params0)
    local_loss_fn = make_local_loss(model, cfg, params0)
    params, opt = params0, sgd_init(params0)
    for i in range(int(epochs_k) * cfg.batches_per_epoch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        rows = idx[i]
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(local_loss_fn(p, x[rows], y[rows]), leaves)
        with torch.no_grad():
            params, opt = sgd_step(tree_unflatten(p, list(grads)), opt,
                                   tree_map(lambda t: t.detach(), p),
                                   lr=cfg.lr, momentum=cfg.momentum)
    with torch.no_grad():
        sigma = torch.tensor(sigma_k, dtype=torch.float32,
                             device=idx.device)
        return tree_unflatten(params, [leaf + sigma * n for leaf, n in
                                       zip(tree_leaves(params), noise)])


def local_loss(model: ClassifierModel, params: Params, x: torch.Tensor,
               y: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Masked mean loss of `params` on clients' padded data, used by
    Power-of-Choice to rank candidates: x (N, cap, ...), y (N, cap),
    n_valid (N,) -> (N,).

    The model runs one client's `cap` rows a call: a matrix product's bits
    may depend on its row count (on the CPU a (13 cap)-row product and
    blocks of it differ by ~5e-7), so a client's loss has the same bits
    whether its rows come with all N clients' or with one block's of a
    client-sharded run (`launch/mesh.py`)."""
    n, cap = y.shape
    with torch.no_grad():
        logits = torch.stack([model.apply(params, x[i]) for i in range(n)])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.to(torch.int64)[..., None])[..., 0]
        mask = (torch.arange(cap, device=y.device)[None, :]
                < n_valid[:, None]).to(torch.float32)
        return (torch.sum((logz - gold) * mask, dim=-1)
                / torch.clamp_min(torch.sum(mask, dim=-1), 1.0))
