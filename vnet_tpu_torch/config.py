"""Config system, shared with the JAX package.

``vnet_tpu.config`` imports no JAX (only ``json`` and ``yaml``), so the port
reads the same JSON schema and pipeline YAML through it unchanged.
"""

from vnet_tpu.config import (Config, ConfigError, EvaluationConfig,
                             NetworkConfig, TrainingConfig, load_config,
                             load_pipeline, parse_config)

__all__ = [
    "Config", "ConfigError", "EvaluationConfig", "NetworkConfig",
    "TrainingConfig", "load_config", "load_pipeline", "parse_config",
]
