"""Simulation presets of the paper's setting (and their synthetic-trace
counterparts), and one module per ported LM architecture (``CONFIG``; see
``models.registry``)."""
from .paper_cluster import (PAPER_CPU, PAPER_FULL, PAPER_TABLE2, TRACE_CPU,
                            TRACE_FULL)

__all__ = ["PAPER_CPU", "PAPER_FULL", "PAPER_TABLE2", "TRACE_CPU",
           "TRACE_FULL"]
