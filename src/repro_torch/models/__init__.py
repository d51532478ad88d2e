"""The dense decoder-only LM that serves on an evolved multiplier."""
