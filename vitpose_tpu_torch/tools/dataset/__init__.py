"""Dataset conversion tools of the port (run with ``python -m``): raw
releases to COCO-style jsons."""
