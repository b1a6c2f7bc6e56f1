"""Judges, one module per coding family, found by the name a configuration
gives in `judge`."""
