"""Analysis tools of the port: FLOPs, speed, profiles, the overfit check
and the int8 sweep (run with ``python -m``)."""
