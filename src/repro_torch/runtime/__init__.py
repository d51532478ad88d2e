"""Fault-tolerance runtime of the port (pure Python)."""
