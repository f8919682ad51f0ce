"""Assigned-architecture registry: ``--arch <id>`` resolves here.

A copy of `repro/configs/` (pure data), so that `get_config` agrees with
the reference by name.  Each module defines CONFIG (exact assigned spec,
source cited).  The port's LM model (`repro_torch.models.lm.model`)
serves and trains all of them.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm.config import ArchConfig

ARCH_IDS = [
    "mamba2_370m",
    "h2o_danube_3_4b",
    "chatglm3_6b",
    "kimi_k2_1t_a32b",
    "qwen3_moe_30b_a3b",
    "internvl2_76b",
    "hymba_1_5b",
    "mistral_nemo_12b",
    "whisper_medium",
    "tinyllama_1_1b",
]

# CLI ids use dashes; module names use underscores
def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


# §Perf-winning overrides (EXPERIMENTS.md hillclimb log).  Baselines stay the
# papers' literal specs; `get_config(name, tuned=True)` applies these.
TUNED_OVERRIDES = {
    "tinyllama_1_1b": {"parallelism": "dp"},                      # 3.5x
    "hymba_1_5b": {"parallelism": "dp", "attn_remat": True,       # 36x
                   "ssm_chunk": 64},
    "kimi_k2_1t_a32b": {"param_dtype": "bfloat16",                # -6% mem;
                        "attn_remat": True},                      # bf16 wins on TPU
}


def get_config(name: str, *, tuned: bool = False) -> ArchConfig:
    import dataclasses
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    cfg = mod.CONFIG
    if tuned:
        over = TUNED_OVERRIDES.get(_norm(name))
        if over:
            cfg = dataclasses.replace(cfg, **over)
    return cfg


def list_configs() -> list[str]:
    return list(ARCH_IDS)
