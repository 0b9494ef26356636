"""Architecture registry: --arch <id> -> model config and instance, and the
input specs of a cell, for the JAX package's ten architectures."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from .encdec import EncDecLM
from .lm import DecoderLM, ModelConfig

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "granite-20b": "granite_20b",
    "llama3.2-1b": "llama3_2_1b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-14b": "qwen3_14b",
    "xlstm-125m": "xlstm_125m",
    "chameleon-34b": "chameleon_34b",
    "whisper-small": "whisper_small",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def build_model(cfg_or_name):
    """``EncDecLM`` for the audio family, ``DecoderLM`` for the others."""
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    if cfg.family == "audio":
        return EncDecLM(cfg)
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
        moe_capacity_factor=4.0,  # dropless at smoke-test scale
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=24 if cfg.enc_layers else 1500,
        dtype=torch.float32,
    )


def input_specs(cfg: ModelConfig, shape_cfg) -> dict:
    """``meta`` stand-ins for every model input of an (arch, shape) cell:
    the shapes and dtypes of the JAX package's ``ShapeDtypeStruct``s, no
    storage. int32 tokens (and labels for a train cell), bf16 ``frames``
    [B, enc_seq, D] for audio; a decode cell's one new token a row."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shape_cfg.kind == "decode":
        return {"tokens": meta((b,))}
    specs = {"tokens": meta((b, s))}
    if shape_cfg.kind == "train":
        specs["labels"] = meta((b, s))
    if cfg.family == "audio":
        specs["frames"] = meta((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return specs
