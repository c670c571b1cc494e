"""The legacy flag command lines of the port: ``python -m
vnet_tpu_torch.flags.train`` and ``python -m vnet_tpu_torch.flags.evaluate``,
counterparts of the repo's ``train.py`` and ``evaluate.py``."""
