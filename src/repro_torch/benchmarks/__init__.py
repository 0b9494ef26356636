"""The port's benchmarks over the scale presets of ``common``: the
paper's Table 2 (``table2_policies``), Figs. 1–2 (``fig1_priors``,
``fig2_pricing``), the marginal ablation, the fleet's router comparison
(``fleet_bench``), the scenario sweep, drift recalibration
(``drift_bench``), calibration and the K-curve (``tuning_bench``), the
online engine (``serve_bench``) and the kernels (``kernels_bench``); ``run``
is one CLI over all of them."""
