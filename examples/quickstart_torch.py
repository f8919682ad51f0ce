"""Quickstart on the PyTorch port: GreedyFed vs FedAvg on synthetic MNIST
under heterogeneity.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of `examples/quickstart.py`: the same two federated
trainings (N=20 clients, Dirichlet alpha=1e-4, T=25 rounds, difficulty 3.0
and per-client privacy noise) through `repro_torch.federated.server`, and
the same accuracy-vs-round table.  The port's draws are its own
(`federated/draws.py`), so its accuracies are not the reference's, only
alike in kind: after the round-robin valuation phase, GreedyFed's greedy
Shapley selection pulls ahead of uniform sampling.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.data.synth import make_dataset
from repro_torch.device import resolve_device
from repro_torch.federated.client import ClientConfig
from repro_torch.federated.server import FLConfig, run_federated


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # difficulty 3.0 + per-client privacy noise: the regime where biased
    # selection matters; easier settings saturate and every strategy ties
    common = dict(
        dataset="mnist", n_clients=20, m=3, rounds=25,
        dirichlet_alpha=1e-4, privacy_sigma=0.05, seed=0,
        n_train=2500, n_val=300, n_test=500, eval_every=5,
        client=ClientConfig(epochs=3, batches_per_epoch=3, batch_size=32),
    )
    data = make_dataset("mnist", n_train=2500, n_val=300, n_test=500,
                        difficulty=3.0, seed=0)

    results = {}
    for selector in ("greedyfed", "fedavg"):
        print(f"== training with {selector} on {device} ==")
        res = run_federated(FLConfig(selector=selector, **common), data=data,
                            device=device)
        results[selector] = res
        print(f"   final acc {res.final_acc:.3f} "
              f"(wall {res.wall_time_s:.0f}s, "
              f"shapley evals {res.shapley_evals})")

    print("\nround | greedyfed | fedavg")
    for (r1, a1), (_, a2) in zip(results["greedyfed"].test_acc,
                                 results["fedavg"].test_acc):
        print(f"{r1:5d} | {a1:9.3f} | {a2:6.3f}")

    gf = results["greedyfed"]
    top = gf.sv_final.argsort()[-3:][::-1]
    print(f"\nGreedyFed's top-3 clients by cumulative Shapley value: {top}")
    print(f"their selection counts: {gf.selection_counts[top]}")


if __name__ == "__main__":
    main()
