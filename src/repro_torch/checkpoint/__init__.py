"""Atomic on-disk writes shared by the results layer and the registry."""
