"""Input preparation of the port (its own copy; the JAX package's data
modules are not imported)."""
