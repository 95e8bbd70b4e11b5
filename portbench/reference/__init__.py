"""The plain reference: the weights maker both sides load, and the
float32 model that judges the port's served tokens.  Nothing here imports
the port, the JAX package or JAX."""
