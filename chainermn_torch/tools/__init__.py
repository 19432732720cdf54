"""Command-line tools of the port, each run with ``python -m``:
``chainermn_torch.tools.supervise`` (the per-host restart loop),
``chainermn_torch.tools.chaos`` (validate a fault spec, or run a command
under it), ``serve_lm`` and ``fleet_lm`` (a serving replica, a fleet),
``schedtune`` (the collective-schedule tuner), ``synth`` (enumerate,
price and emit synthesized collective programs), ``profile_lm`` (the
LM train step's device profile and roofline) and ``dlint`` (the port's
distributed-correctness lint, and its trace passes)."""
