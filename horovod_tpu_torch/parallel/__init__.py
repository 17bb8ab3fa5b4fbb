"""Parallelism library of the port: the oracle attention and the two-tier
(host-group) reduction."""
