"""End-to-end example on the PyTorch port: federated fine-tuning of a
transformer LM with GreedyFed client selection.

    PYTHONPATH=src python examples/federated_lm_torch.py [--arch
        tinyllama_1_1b] [--rounds 30] [--d-model 256] [--layers 4]
        [--device cpu]

The counterpart of `examples/federated_lm.py`, with the same CLI (plus
`--device`, default the CUDA card) and output lines.  N simulated clients
each hold a private synthetic token stream with a client-specific skew
(distinct "dialects" = heterogeneity).  Each round the server selects M
clients (`repro_torch.core.selection`'s device selector stack), every
selected client runs E local AdamW steps from the server model, the server
aggregates (`weighted_average`), values contributions with GTG-Shapley
(`core/shapley.py::gtg_shapley`) on a held-out validation stream, and
updates cumulative SVs.  The streams, batches and selection draws come
from torch generators seeded as the run is (the reference's threefry draws
differ).  On the card, `--seq` above 1024 sends attention to the flash
kernels, forward and backward, at any head dim (above 128, as at
`--d-model 1024`, their wide route).
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.aggregation import (
    normalized_weights, tree_stack, weighted_average,
)
from repro_torch.core.selection import (
    DeviceSelectionContext, SelectionDraw, device_select, device_update,
    init_device_state, make_selector_spec, poc_d_schedule,
)
from repro_torch.core.shapley import gtg_shapley, permutation_block
from repro_torch.device import resolve_device
from repro_torch.models.lm import model as M
from repro_torch.tree import tree_leaves


def make_client_streams(gen, n_clients, vocab, length, n_dialects=4):
    """Synthetic heterogeneous corpora: bigram chains per dialect.  Client
    c's stream is its dialect's band cycled, with a fraction 0.1 + 0.8 c / N
    of its tokens replaced by uniform noise (low ids are cleaner)."""
    device = gen.device
    streams, qualities = [], []
    band = vocab // n_dialects
    for c in range(n_clients):
        lo = (c % n_dialects) * band
        noise = 0.1 + 0.8 * (c / n_clients)
        clean = lo + torch.arange(length, device=device) % band
        rand = torch.randint(0, vocab, (length,), generator=gen,
                             device=device)
        mask = torch.rand((length,), generator=gen, device=device) < noise
        streams.append(torch.where(mask, rand, clean))
        qualities.append(1.0 - noise)
    return torch.stack(streams), np.asarray(qualities)


def sample_batch(stream, gen, batch, seq):
    """`batch` windows of `seq` tokens at random starts of `stream`."""
    starts = torch.randint(0, stream.shape[0] - seq - 1, (batch,),
                           generator=gen, device=stream.device)
    idx = starts[:, None] + torch.arange(seq, device=stream.device)
    return {"tokens": stream[idx]}


def setup(args, device=None) -> dict:
    """The run's config, model, client streams, validation batch,
    selector state and generators (everything `run_round` reads)."""
    device = resolve_device(device)
    cfg = get_config(args.arch).reduced(n_layers=args.layers,
                                        d_model=args.d_model)
    cfg = dataclasses.replace(cfg, vocab=1024, dtype="float32")
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device)
    streams, quality = make_client_streams(gen, args.clients, cfg.vocab,
                                           8192)
    val_stream = streams[0][:2048]  # server-side validation stream
    val_batch = {"tokens": val_stream[: (2048 // args.seq) * args.seq]
                 .reshape(-1, args.seq)}
    opt_init, train_step = M.make_train_step(cfg)
    spec = make_selector_spec(args.selector, args.clients, args.select)
    return dict(
        args=args, cfg=cfg, device=device, gen=gen, params=params,
        streams=streams, quality=quality, val_batch=val_batch,
        opt_init=opt_init, train_step=train_step, spec=spec,
        state=init_device_state(spec, seed=0, device=device),
        d_sched=poc_d_schedule(spec, args.rounds),
        perm_gen=torch.Generator().manual_seed(999),
        fractions=torch.ones(args.clients, device=device) / args.clients,
        n_k=torch.ones(args.select, device=device))


def utility(run, p) -> torch.Tensor:
    """The server's utility of a model: minus its validation loss."""
    return -M.loss_fn(run["cfg"], p, run["val_batch"])


def client_update(run, p, stream):
    """E local AdamW steps from the server model `p` on `stream`."""
    args = run["args"]
    opt = run["opt_init"](p)
    for _ in range(args.local_steps):
        p, opt, _ = run["train_step"](p, opt, sample_batch(
            stream, run["gen"], args.batch, args.seq))
    return p


def _selection_draw(run) -> SelectionDraw:
    args, gen = run["args"], run["gen"]
    choice = torch.randperm(args.clients, generator=gen,
                            device=gen.device)[:args.select]
    u = torch.rand((args.clients,), generator=gen, device=gen.device)
    tiny = torch.finfo(torch.float32).tiny
    return SelectionDraw(choice, -torch.log(-torch.log(u.clamp(tiny, 1.0))))


def run_round(run, t: int):
    """One GreedyFed round: select, train the cohort locally, value it by
    GTG-Shapley (strategies that use SVs), aggregate, update the selector
    state.  Returns (selected client ids, the round's SVs or None)."""
    args, cfg, spec = run["args"], run["cfg"], run["spec"]
    params = run["params"]
    losses = torch.zeros(args.clients, device=run["device"])
    if spec.uses_local_losses:   # Power-of-Choice ranks by w^t loss
        with torch.no_grad():
            losses = torch.stack([M.loss_fn(cfg, params, sample_batch(
                run["streams"][c], run["gen"], args.batch, args.seq))
                for c in range(args.clients)])
    ctx = DeviceSelectionContext(data_fractions=run["fractions"],
                                 local_losses=losses,
                                 poc_d=int(run["d_sched"][t]))
    sel, state = device_select(spec, run["state"], ctx, _selection_draw(run))
    sel_ids = sel.tolist()
    stacked = tree_stack([client_update(run, params, run["streams"][c])
                          for c in sel_ids])
    sv_round = None
    if spec.uses_shapley:
        sv_round, _ = gtg_shapley(
            stacked, run["n_k"], params, lambda p: utility(run, p),
            permutation_block(run["perm_gen"], args.select, 20),
            max_iters=20)
    run["params"] = weighted_average(stacked, normalized_weights(run["n_k"]))
    run["state"] = device_update(spec, state, sel, sv_round=sv_round)
    return sel_ids, sv_round


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--select", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--selector", default="greedyfed")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    run = setup(args, args.device)
    n_params = sum(x.numel() for x in tree_leaves(run["params"]))
    print(f"# federated LM: {run['cfg'].name} ({n_params/1e6:.1f}M params), "
          f"N={args.clients} M={args.select} T={args.rounds}")

    t0 = time.time()
    print("round,val_loss,selected")
    for t in range(args.rounds):
        sel, _ = run_round(run, t)
        if t % 5 == 0 or t == args.rounds - 1:
            with torch.no_grad():
                vl = float(-utility(run, run["params"]))
            print(f"{t},{vl:.4f},{sel}")

    sv = run["state"].valuation.sv.cpu().numpy()
    quality = run["quality"]
    rank = sv.argsort()[::-1]
    print(f"# wall {time.time()-t0:.0f}s")
    print(f"# client quality (true):   {np.round(quality, 2).tolist()}")
    print(f"# SV ranking (discovered): {rank.tolist()}")
    # GreedyFed should discover that low-noise clients contribute most
    top_half = set(rank[: args.clients // 2].tolist())
    true_top = set(quality.argsort()[::-1][: args.clients // 2].tolist())
    overlap = len(top_half & true_top) / max(len(true_top), 1)
    print(f"# top-half overlap between SV ranking and true quality: "
          f"{overlap:.2f}")


if __name__ == "__main__":
    main()
