"""Plots and the data behind them (the JAX package's ``plotting/``):
render-to-image helpers, FVU frontiers, sweep grids, activity and dead
features, autointerp comparisons, time series over training snapshots,
and the erasure plots. matplotlib is imported only to draw."""
