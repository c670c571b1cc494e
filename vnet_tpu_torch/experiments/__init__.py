"""Experiment scripts of the port (``python -m
vnet_tpu_torch.experiments.<name>``), counterparts of the repo's
``scripts/experiments``."""
