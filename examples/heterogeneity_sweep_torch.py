"""Robustness demo on the PyTorch port: GreedyFed vs baselines under
stragglers + privacy noise.

    PYTHONPATH=src python examples/heterogeneity_sweep_torch.py          # card
    PYTHONPATH=src python examples/heterogeneity_sweep_torch.py --device cpu

The counterpart of `examples/heterogeneity_sweep.py`: the same 4-setting x
3-selector sweep (50% stragglers and per-client privacy noise, each alone
and together; greedyfed, ucb, fedavg; N=20, T=25) as ONE
`repro_torch.grid.run_grid` run.  Each (setting, selector) pair is a
GridCell whose knob overrides become per-replica scan operands; the cells
are partitioned by capability (the fedavg column skips GTG-Shapley
entirely), and on the card each partition's rounds replay as one captured
CUDA graph holding all its replicas.  The port's draws are its own, so its
accuracies are the reference's only in kind.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.data.synth import make_dataset
from repro_torch.device import resolve_device
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig
from repro_torch.grid import GridCell, GridSpec, run_grid

SETTINGS = [
    ("clean", {}),
    ("stragglers x=0.5", {"straggler_frac": 0.5}),
    ("noise sigma=0.1", {"privacy_sigma": 0.1}),
    ("both", {"straggler_frac": 0.5, "privacy_sigma": 0.1}),
]
SELECTORS = ("greedyfed", "ucb", "fedavg")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data = make_dataset("mnist", n_train=2500, n_val=300, n_test=500,
                        difficulty=3.0, seed=1)
    base = FLConfig(
        dataset="mnist", n_clients=20, m=3, rounds=25, dirichlet_alpha=1e-4,
        seed=1, n_train=2500, n_val=300, n_test=500, eval_every=25,
        client=ClientConfig(epochs=3, batches_per_epoch=3, batch_size=32),
    )
    spec = GridSpec(base, tuple(
        GridCell(sel, seed=1, overrides=knobs)
        for _, knobs in SETTINGS for sel in SELECTORS))

    out = run_grid(spec, data=data, device=device)
    print(f"{len(spec.cells)} cells, {len(out.partitions)} partitions, "
          f"{out.dispatches} dispatches, {out.wall_time_s:.1f}s on {device}")

    print("setting           | greedyfed | ucb   | fedavg")
    results = iter(out.results)
    for name, _ in SETTINGS:
        accs = {sel: next(results).final_acc for sel in SELECTORS}
        print(f"{name:17s} | {accs['greedyfed']:9.3f} | {accs['ucb']:.3f} "
              f"| {accs['fedavg']:.3f}")


if __name__ == "__main__":
    main()
