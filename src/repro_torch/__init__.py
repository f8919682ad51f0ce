"""PyTorch/CUDA port of the GreedyFed system in `repro`.

The package mirrors `repro`'s layout and module names, so each module's
counterpart is easy to find, but it imports `torch` and `numpy` only:
never JAX and nothing from `repro`.  Parameters are plain nested dicts of
tensors with the reference's keys and shapes, every random draw takes an
explicit `torch.Generator` (or an injected draw), and every entry point
takes an explicit `device`, which defaults to the CUDA card.
"""
