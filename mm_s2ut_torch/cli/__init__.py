"""Command-line entry points of the port (``python -m mm_s2ut_torch.cli.*``)."""
