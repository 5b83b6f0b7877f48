"""Counterpart of ``repro.parallel``: only what the copied compiler imports."""
