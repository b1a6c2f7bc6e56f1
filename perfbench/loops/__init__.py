"""Closed loops of the traffic mixes, one module each (`Loop`), found by the
name a mix gives in `loop`."""
