"""Example training scripts of the port, runnable as
``python -m chainermn_torch.examples.<name>``."""
