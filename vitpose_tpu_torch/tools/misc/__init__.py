"""Miscellaneous tools of the port (run with ``python -m``): pseudo-labels
and checkpoint publishing."""
