"""Deterministic synthetic data (the operand histograms of sampling)."""
