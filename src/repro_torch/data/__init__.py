"""The training data tier (port of ``repro.data``)."""
