"""Plain references, one module per family of configurations; a
configuration names its own under `reference`."""
