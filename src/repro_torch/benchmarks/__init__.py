"""The port's benchmarks over the scale presets of ``common``: the
paper's Table 2 (``table2_policies``), Figs. 1–2 (``fig1_priors``,
``fig2_pricing``), the marginal ablation, and the fleet's router
comparison (``fleet_bench``)."""
