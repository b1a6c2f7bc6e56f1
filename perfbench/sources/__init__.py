"""Image sources of the configurations, one module each (`images(spec, seed,
device)`), found by the name a configuration gives in `images.source`."""
