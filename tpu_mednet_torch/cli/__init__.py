"""Command-line entry points of the port: ``python -m tpu_mednet_torch.cli.train_seg``
and ``python -m tpu_mednet_torch.cli.predict``."""
