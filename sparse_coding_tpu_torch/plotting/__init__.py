"""Render-to-image helpers (the port's subset of the JAX package's
``plotting/``)."""
