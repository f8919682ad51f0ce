"""Training launcher: federated (GreedyFed) or plain LM training on the
PyTorch port.  Counterpart of `repro/launch/train.py`: the same CLI,
defaults and printed lines, plus `--device` (default the CUDA card).

    PYTHONPATH=src python -m repro_torch.launch.train --mode federated \\
        --dataset mnist --selector greedyfed --rounds 50
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
        --arch tinyllama_1_1b --seq 2048 --batch-size 4
    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
        --arch tinyllama_1_1b --steps 100 --d-model 256 --layers 4 \\
        --device cpu

LM mode trains the full config unless `--layers` or `--d-model` asks for a
reduced one (float32 activations, `--vocab` tokens), on one device, from
random weights drawn from `--seed`, on random token batches from the same
generator.  The reference runs under a production mesh on real hardware;
the port runs on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.device import resolve_device


def run_federated_mode(args) -> None:
    from repro_torch.federated.client import ClientConfig
    from repro_torch.federated.server import FLConfig, run_federated

    cfg = FLConfig(
        dataset=args.dataset, selector=args.selector,
        n_clients=args.clients, m=args.select, rounds=args.rounds,
        dirichlet_alpha=args.alpha, straggler_frac=args.stragglers,
        privacy_sigma=args.sigma, seed=args.seed,
        n_train=args.n_train, n_val=args.n_val, n_test=args.n_test,
        eval_every=max(args.rounds // 10, 1),
        client=ClientConfig(epochs=args.epochs,
                            batches_per_epoch=args.batches,
                            batch_size=args.batch_size),
    )
    res = run_federated(cfg, device=args.device)
    print("round,test_acc")
    for rnd, acc in res.test_acc:
        print(f"{rnd},{acc:.4f}")
    print(f"# final={res.final_acc:.4f} shapley_evals={res.shapley_evals} "
          f"wall={res.wall_time_s:.1f}s")
    if args.checkpoint:
        from repro_torch.checkpoint.ckpt import save_server_state
        save_server_state(args.checkpoint, params=res.params,
                          sv=res.sv_final, counts=res.selection_counts,
                          round_idx=cfg.rounds, seed=cfg.seed)
        print(f"# checkpoint -> {args.checkpoint}")


def lm_config(args):
    """The arch's config, or its reduced local variant when `--layers` or
    `--d-model` is given (float32 activations, `--vocab` tokens)."""
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.layers or args.d_model:  # reduced local run
        cfg = dataclasses.replace(
            cfg.reduced(n_layers=args.layers or 2,
                        d_model=args.d_model or 256),
            vocab=args.vocab, dtype="float32")
    return cfg


def build_lm(cfg, seed: int, device):
    """Random params from `seed` on `device`, the optimizer state and the
    train step: (params, opt_state, step, generator).  The generator lives
    on `device` and goes on to draw the batches."""
    from repro_torch.models.lm import model as M

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device=device)
    opt_init, step = M.make_train_step(cfg)
    return params, opt_init(params), step, gen


def synth_batch(cfg, gen: torch.Generator, batch_size: int,
                seq: int) -> dict:
    """A batch of uniform random tokens (B, S) on `gen`'s device, with the
    frontend stubs' inputs the reference's launcher draws: normal "patches"
    (B, n_frontend_tokens, D) for vision, normal "frames" (B, max(
    n_frontend_tokens, 8), D) for audio."""
    dev = gen.device
    batch = {"tokens": torch.randint(0, cfg.vocab, (batch_size, seq),
                                     generator=gen, device=dev)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(
            (batch_size, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=dev)
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(
            (batch_size, max(cfg.n_frontend_tokens, 8), cfg.d_model),
            generator=gen, device=dev)
    return batch


def run_lm_mode(args) -> None:
    cfg = lm_config(args)
    params, opt, step, gen = build_lm(cfg, args.seed, args.device)

    print("step,loss,tok_per_s")
    t0 = time.time()
    for i in range(args.steps):
        params, opt, metrics = step(params, opt, synth_batch(
            cfg, gen, args.batch_size, args.seq))
        if i % max(args.steps // 20, 1) == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])      # waits for the step
            dt = time.time() - t0
            tps = (i + 1) * args.batch_size * args.seq / max(dt, 1e-9)
            print(f"{i},{loss:.4f},{tps:.0f}")
    assert math.isfinite(float(metrics["loss"]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["federated", "lm"], default="federated")
    # federated
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--selector", default="greedyfed")
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--select", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--alpha", type=float, default=1e-4)
    ap.add_argument("--stragglers", type=float, default=0.0)
    ap.add_argument("--sigma", type=float, default=0.0)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=6000)
    ap.add_argument("--n-val", type=int, default=500)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--checkpoint", default=None)
    # lm
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=2048)
    # shared
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.mode == "federated":
        run_federated_mode(args)
    else:
        run_lm_mode(args)


if __name__ == "__main__":
    main()
