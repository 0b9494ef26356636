"""LM scaffold: the decoder LM (every decoder family) and the
encoder-decoder (audio), behind a registry of the ten architectures."""
from .encdec import EncDecLM
from .lm import DecoderLM, ModelConfig
from .registry import (ARCH_NAMES, build_model, get_config, input_specs,
                       reduced_config)

__all__ = ["DecoderLM", "EncDecLM", "ModelConfig", "ARCH_NAMES",
           "build_model", "get_config", "input_specs", "reduced_config"]
