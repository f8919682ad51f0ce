"""Serving example on the PyTorch port: batched greedy decode with a
prefilled ring-buffer KV cache, and per-request Shapley attribution.

    PYTHONPATH=src python examples/serve_shapley_torch.py            # card
    PYTHONPATH=src python examples/serve_shapley_torch.py --device cpu

The counterpart of `examples/serve_shapley.py`: the same reduced
H2O-Danube-3 architecture, batch, prompt and generation lengths, through
`repro_torch.serve.serve_requests`.  Telemetry (`--events`, `--trace-dir`)
is not ported yet.
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import model as M
from repro_torch.serve import serve_requests


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("h2o_danube_3_4b").reduced(n_layers=4, d_model=256)
    cfg = dataclasses.replace(cfg, vocab=512, dtype="float32", window=64)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, gen, device=device)

    b, prompt_len, gen_len = 4, 256, 32
    tokens = torch.randint(0, cfg.vocab, (b, prompt_len), generator=gen,
                           device=device)
    res = serve_requests(cfg, params, tokens, gen_len, device=device)
    print(f"# prefill {b}x{prompt_len} in {res.prefill_s:.3f}s on {device} "
          f"(SWA ring cache: {cfg.window} slots/layer)")
    print(f"# decoded {gen_len} steps x {b} seqs in {res.decode_s:.3f}s "
          f"({res.tokens_per_s:.1f} tok/s)")
    print("# generated token ids (first 10 per request):")
    for r in range(b):
        print(f"  req{r}: {res.generated[r, :10].tolist()}  mean logprob "
              f"{float(res.logprob_sum[r]) / gen_len:.3f}")
    print(f"# request Shapley values of batch logprob: "
          f"{[round(float(x), 3) for x in res.sv]}")


if __name__ == "__main__":
    main()
