"""Sparse ops and the hand-written Hopper kernels behind them."""
