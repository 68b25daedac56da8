from infercnv_tpu_torch.sim.meanvar import (  # noqa: F401
    fit_dropout_spline,
    fit_mean_var_spline,
    get_mean_var_table,
    get_mean_vs_p0_table,
    simulate_meanvar_counts,
    simulate_simple_counts,
)
