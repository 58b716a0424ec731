"""Observability of the port: for now the tenant identity of
obs/usage.py, which the match scheduler's QoS keys on."""
