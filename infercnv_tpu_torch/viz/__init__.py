"""Plots and their statistics.  For now only the MCMC diagnostic statistic
step 18 reads (``bayes_plots.gelman_rubin``); the heatmaps and the Bayes
plots are not ported yet (ROADMAP A7.3)."""
