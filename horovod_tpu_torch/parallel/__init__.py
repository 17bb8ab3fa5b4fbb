"""Parallelism library of the port (so far the oracle attention only)."""
