"""Counterpart of ``repro.checkpoint``: checkpoints in the reference's layout."""
