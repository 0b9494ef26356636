"""Simulation presets of the paper's setting."""
from .paper_cluster import PAPER_CPU, PAPER_FULL, PAPER_TABLE2

__all__ = ["PAPER_CPU", "PAPER_FULL", "PAPER_TABLE2"]
