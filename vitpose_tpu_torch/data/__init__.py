"""Dataset metadata and input constants of the port."""
