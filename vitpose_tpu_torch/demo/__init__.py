"""The top-down and bottom-up demos of the repo's demo/ folder on the port, each run as
`python -m vitpose_tpu_torch.demo.<name>` with JAX's flags and defaults
plus `--device` (CUDA by default; it raises without CUDA), and a
`main(argv=None)` that returns what it wrote."""
