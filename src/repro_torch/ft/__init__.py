"""Counterpart of ``repro.ft``: the fault-tolerant training loop and its
chaos harness."""
