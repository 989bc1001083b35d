"""Entry points run from the command line (``python -m
repro_torch.launch.serve``)."""
