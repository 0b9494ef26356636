"""Architecture registry: --arch <id> -> model config and instance, for the
architectures ported so far."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from .lm import DecoderLM, ModelConfig

_ARCH_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)

# the JAX package's other architectures, not ported yet (ROADMAP.md, Queue A,
# item 10)
NOT_PORTED = ("hymba-1.5b", "moonshot-v1-16b-a3b", "dbrx-132b",
              "granite-20b", "starcoder2-3b", "qwen3-14b", "xlstm-125m",
              "chameleon-34b", "whisper-small")


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        if name in NOT_PORTED:
            raise KeyError(f"arch {name!r} is not ported yet (ROADMAP.md, "
                           f"Queue A, item 10); ported: {ARCH_NAMES}")
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}, not "
                       f"yet ported: {NOT_PORTED}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def build_model(cfg_or_name) -> DecoderLM:
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    return DecoderLM(cfg)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (the JAX package's
    ``reduced_config``: 2 layers, d_model 64, head_dim 16, float32)."""
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    heads = (heads // kv) * kv
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_capacity_factor=4.0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=24 if cfg.enc_layers else 1500,
        dtype=torch.float32,
    )
