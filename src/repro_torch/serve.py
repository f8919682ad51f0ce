"""Serving loop: prefill, greedy ring-cache decode, per-request Shapley.

Counterpart of the loop in `examples/serve_shapley.py`: prefill a batch of
prompts, decode greedily against the ring-buffer KV cache while summing
each request's log-probability of its chosen tokens, then attribute the
batch objective across the requests with the exact Shapley value (clients
== requests; U(S) = the n_k-weighted average of the members' summed
log-probabilities, U(empty) = 0, as the example sets it up).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.core.aggregation import tree_stack
from repro_torch.core.shapley import exact_shapley
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.lm import model as M
from repro_torch.models.lm.config import ArchConfig


class ServeResult(NamedTuple):
    generated: torch.Tensor     # (B, gen_len) int64: the tokens fed to decode
    logprob_sum: torch.Tensor   # (B,) f32: summed log-probs of chosen tokens
    sv: torch.Tensor            # (B,) f32: request Shapley values
    prefill_s: float            # host seconds, device synchronised
    decode_s: float
    tokens_per_s: float         # B * gen_len / decode_s
    shapley_s: float


def request_shapley(logprob_sum: torch.Tensor) -> torch.Tensor:
    """Exact Shapley values of the requests for the batch objective; they
    sum to the grand coalition's utility, the mean summed log-prob."""
    b = logprob_sum.shape[0]
    stacked = tree_stack([{"lp": logprob_sum[r][None]} for r in range(b)])
    zero = {"lp": torch.zeros((1,), device=logprob_sum.device)}
    return exact_shapley(stacked, torch.ones((b,), device=logprob_sum.device),
                         zero, lambda p: torch.sum(p["lp"]))


def serve_requests(cfg: ArchConfig, params, tokens: torch.Tensor,
                   gen_len: int, *, device=None) -> ServeResult:
    """Serve a batch of prompts `tokens` (B, S): prefill with room for
    `gen_len` more positions, then `gen_len` greedy decode steps.  The
    first fed token is the prefill's argmax; each step adds the log-prob
    of the argmax of its logits, which is the next token fed."""
    device = resolve_device(device)
    tokens = tokens.to(device)
    b = tokens.shape[0]
    synchronize(device)
    t0 = time.perf_counter()
    cache, logits = M.prefill_step(cfg, params, {"tokens": tokens},
                                   cache_len=tokens.shape[1] + gen_len)
    synchronize(device)
    prefill_s = time.perf_counter() - t0

    out = []
    logprob_sum = torch.zeros((b,), dtype=torch.float32, device=device)
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for _ in range(gen_len):
        out.append(tok)
        cache, logits = M.decode_step(cfg, params, cache, {"token": tok})
        lp = torch.log_softmax(logits, dim=-1)
        tok = torch.argmax(logits, dim=-1)
        logprob_sum += torch.gather(lp, 1, tok[:, None])[:, 0]
    synchronize(device)
    decode_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sv = request_shapley(logprob_sum)
    synchronize(device)
    shapley_s = time.perf_counter() - t0
    generated = (torch.stack(out, 1) if out else
                 torch.zeros((b, 0), dtype=torch.int64, device=device))
    return ServeResult(generated, logprob_sum, sv, prefill_s, decode_s,
                       b * gen_len / max(decode_s, 1e-12), shapley_s)
