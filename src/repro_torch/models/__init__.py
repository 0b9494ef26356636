"""LM scaffold: the decoder LM (dense and vlm families) behind a registry of
the ported architectures."""
from .lm import DecoderLM, ModelConfig
from .registry import ARCH_NAMES, build_model, get_config, reduced_config

__all__ = ["DecoderLM", "ModelConfig", "ARCH_NAMES", "build_model",
           "get_config", "reduced_config"]
