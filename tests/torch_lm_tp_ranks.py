"""Rank bodies of the LM mesh tests (tests/test_torch_sharding.py).

Spawned processes import this module (not the test file, which imports
JAX): each joins a gloo world of 4 ranks through a file store, makes the
(2, 2) ("data", "model") debug mesh, and runs every case of `CASES` on it:
one AdamW train step, a prefill and `DECODE_STEPS` decode steps, each on
this rank's blocks of the same seeded global params.  The results are
gathered back to whole and rank 0 saves them to `out/rank0.pt`.
Everything here is the port's, on the CPU, one torch thread a rank.
"""
from __future__ import annotations

import dataclasses
import os
import traceback

import torch

DECODE_STEPS = 3
BATCH = 4

# name -> (arch, config overrides, train / prefill seq len, serve?)
CASES = {
    # S > 1024 with S % attn_chunk == 0: the flash branch
    "tinyllama_tp": ("tinyllama_1_1b", {"attn_chunk": 128}, 1152, True),
    "tinyllama_dp": ("tinyllama_1_1b", {"parallelism": "dp"}, 64, False),
    "qwen3_moe_fsdp": ("qwen3_moe_30b_a3b", {"fsdp": True}, 64, True),
    # one KV head: replicated KV (a rank's 2 query heads read it), a ring
    # split on its positions (distributed-softmax decode), SSM heads split
    "hymba": ("hymba_1_5b", {"n_kv_heads": 1}, 64, True),
    "mamba2": ("mamba2_370m", {}, 64, True),
    "whisper": ("whisper_medium", {}, 64, True),
}


def case_cfg(name: str):
    """The case's reduced config (2 layers, d_model 256, f32)."""
    from repro_torch.configs import get_config
    arch, over, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def shapes(name: str) -> dict:
    """The case's InputShapes by kind (launch_cfg's MoE groups read them)."""
    from repro_torch.launch.shapes import InputShape
    s_len = CASES[name][2]
    return {"train": InputShape("train", s_len, BATCH, "train"),
            "prefill": InputShape("prefill", s_len, BATCH, "prefill"),
            "decode": InputShape("decode", s_len, BATCH, "decode")}


def inputs(name: str) -> dict:
    """Seeded global params, train / prefill batch and decode tokens."""
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.lm.model import init_params
    cfg = case_cfg(name)
    gen = torch.Generator().manual_seed(7)
    params = init_params(cfg, gen, device="cpu")
    batch = synth_batch(cfg, gen, BATCH, CASES[name][2])
    batch["tokens"] = batch["tokens"].to(torch.int32)   # the dry-run's
    tokens = [torch.randint(0, cfg.vocab, (BATCH,), generator=gen,
                            dtype=torch.int32) for _ in range(DECODE_STEPS)]
    return {"params": params, "batch": batch, "tokens": tokens}


def run_case(name: str, mesh=None) -> dict:
    """The case's train step, prefill and decode steps: on this rank's
    blocks under `mesh` (results gathered back to whole), or on one
    device without it."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch import sharding as S
    from repro_torch.launch.compat import Count, set_mesh
    from repro_torch.models.lm import model as M
    base, kinds = case_cfg(name), shapes(name)
    cfgs = {k: (S.launch_cfg(base, mesh, sh) if mesh is not None else base)
            for k, sh in kinds.items()}
    if mesh is None:         # one device: the same MoE groups
        from repro_torch.launch.mesh import LMMesh
        debug = LMMesh((2, 2), ("data", "model"))
        cfgs = {k: dataclasses.replace(base, moe_groups=S.launch_cfg(
            base, debug, sh).moe_groups) for k, sh in kinds.items()}
    data = inputs(name)
    params = data["params"]
    pspecs = S.param_specs(base, mesh, params) if mesh is not None else None
    if mesh is not None:
        params = S.shard_tree(params, pspecs, mesh)
    out = {}
    with set_mesh(mesh) if mesh is not None else _nothing():
        C.reset()
        opt_init, step = M.make_train_step(cfgs["train"])
        opt0 = opt_init(params)
        rows = (S.shard_tree(data["batch"], S.batch_specs(
            base, mesh, data["batch"]), mesh) if mesh is not None else {})
        rows = {k: v.clone() for k, v in rows.items()}
        with Count() as count:
            if mesh is not None:    # this rank's rows, as the dry-run's
                count.track(params, opt0, rows)
            new, opt, metrics = step(params, opt0, data["batch"])
        out["count"] = count.summary()
        out["train_collectives"] = C.collective_bytes()
        out["loss"] = float(metrics["loss"])
        # AdamW's first moment after one step is 0.1 x the gradient
        out["params"], out["mu"] = ((S.unshard_tree(new, pspecs, mesh),
                                     S.unshard_tree(opt.mu, pspecs, mesh))
                                    if mesh is not None else (new, opt.mu))
        if CASES[name][3]:
            cache, logits = M.prefill_step(cfgs["prefill"], params,
                                           data["batch"])
            steps = [logits]
            for tok in data["tokens"]:
                cache, logits = M.decode_step(cfgs["decode"], params, cache,
                                              {"token": tok},
                                              cache_len=CASES[name][2])
                steps.append(logits)
            if mesh is not None:
                spec = S.logits_spec(base, mesh, BATCH)
                steps = [S.unshard_tree({"l": x}, {"l": spec}, mesh)["l"]
                         for x in steps]
            out["logits"] = steps
    return out


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def main(rank: int, world: int, store: str, out: str, names: list) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    results = {}
    for name in names:
        try:
            results[name] = run_case(name, mesh)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        torch.save(results, os.path.join(out, "rank0.pt"))
    dist.destroy_process_group()


def spawn(tmp, names: list, world: int = 4) -> dict:
    """Every case of `names` on `world` spawned ranks; rank 0's results."""
    import torch.multiprocessing as mp
    store = os.path.join(tmp, "store")
    mp.start_processes(main, args=(world, store, str(tmp), names),
                       nprocs=world, start_method="spawn")
    return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
