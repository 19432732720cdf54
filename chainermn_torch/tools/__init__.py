"""Command-line tools of the port, each run with ``python -m``:
``chainermn_torch.tools.supervise`` (the per-host restart loop) and
``chainermn_torch.tools.chaos`` (validate a fault spec, or run a command
under it)."""
