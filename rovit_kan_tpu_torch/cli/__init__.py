"""Command-line entry points of the port: ``python -m
rovit_kan_tpu_torch.cli.train`` and ``python -m
rovit_kan_tpu_torch.cli.evaluate`` (``--cpu`` off the card)."""
