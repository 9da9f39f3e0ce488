"""Post-processing, the weight bridge from the JAX package, serving, and the
RL refinement steps."""
