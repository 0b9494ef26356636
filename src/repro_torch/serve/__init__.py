"""Online serving layer: the continuous-batching LM engine (``engine``)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
