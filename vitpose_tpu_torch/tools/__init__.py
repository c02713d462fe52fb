"""Command-line entry points of the port (run with ``python -m``): the
evaluation and training CLIs (``test``, ``test_new``, ``train``,
``train_comet``), ``eval_detector``, ``serve``, ``export``,
``run_webcam``, ``model_split``, the ``analysis``, ``dataset`` and
``misc`` tools, and the ``dist_*.sh`` / ``slurm_*.sh`` launchers."""
