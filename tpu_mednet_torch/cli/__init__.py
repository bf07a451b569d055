"""Command-line entry points of the port, each run as ``python -m
tpu_mednet_torch.cli.<name>``: ``train_seg``, ``train_ldmks`` and ``predict``
(on the card unless ``--device cpu``), and the host tools ``demo``,
``evaluate``, ``stats``, ``pack``, ``import_torch``, ``export_torch`` and
``inspect_ckpt``, which use no card."""
