"""Assigned input shapes and (arch × shape) applicability rules.

LM transformer shapes are seq_len × global_batch. ``decode_*`` / ``long_*``
count ``decode_step`` (one new token against a KV cache of seq_len), not the
train step. ``long_500k`` requires sub-quadratic context state and runs
only for the hybrid/ssm archs. The JAX package's ``configs/shapes.py``,
shape for shape.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable(arch_cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and arch_cfg.family not in ("hybrid", "ssm"):
        return False, "pure full-attention arch: 500k dense decode skipped"
    return True, ""
