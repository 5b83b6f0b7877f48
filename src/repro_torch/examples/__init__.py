"""The port's user-facing walk-throughs — counterparts of the repo's
``examples/``. Each runs as ``python -m repro_torch.examples.<name>``; nothing
runs at import."""
