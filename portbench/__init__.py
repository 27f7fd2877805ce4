"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port): coded LM
serving on one H100.  ``run.py`` is the command; see ``README.md``."""
