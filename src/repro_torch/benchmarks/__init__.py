"""The port's benchmark drivers: the paper's Table 2 (``table2_policies``)
over the scale presets of ``common``."""
