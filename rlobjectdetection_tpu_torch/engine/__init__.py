"""Post-processing, the weight bridge from the JAX package, and serving."""
