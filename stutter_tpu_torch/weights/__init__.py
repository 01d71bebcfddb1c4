"""Parameter conversion from the JAX package's pytree, and seeded random init."""
