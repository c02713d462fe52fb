"""Config files, weight carry-over from the JAX package, and the load-time
adaptation of .pth weights."""
