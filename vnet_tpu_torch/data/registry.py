"""Transform registry + YAML pipeline builder.

Replaces the reference's ``getattr`` reflection over the dataset modules
(reference `model.py:341-402`, `pipeline/pipeline.py:18-36`) with an
explicit decorator-based registry, keyed by spatial rank so the same YAML
schema (``preprocess.{train,test,evaluate}.{3D,2D}`` lists of
``{name, variables}``) keeps working.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[int, Dict[str, Callable]] = {2: {}, 3: {}}


def register_transform(dim: int, name: str | None = None):
    """Class decorator: ``@register_transform(3)``."""

    def wrap(cls):
        _REGISTRY[dim][name or cls.__name__] = cls
        return cls

    return wrap


def transform_names(dim: int):
    return sorted(_REGISTRY[dim])


def build_transform(dim: int, name: str, variables: dict | None = None):
    try:
        cls = _REGISTRY[dim][name]
    except KeyError:
        raise ValueError(
            f"Unknown {dim}D transform {name!r}; known: {transform_names(dim)}"
        ) from None
    variables = variables or {}
    return cls(**variables)


def build_transform_list(dim: int, entries) -> list:
    """Build from a YAML section: list of ``{name, variables}`` dicts
    (`model.py:388-402`). ``None``/missing sections yield []."""
    if not entries:
        return []
    out = []
    for entry in entries:
        out.append(build_transform(dim, entry["name"], entry.get("variables")))
    return out


def build_pipeline(pipeline_cfg: dict, phase: str, dimension: int):
    """Build the transform chain(s) for a phase from a parsed pipeline YAML.

    For 3D mode returns a flat list; for 2D mode returns
    ``{"3D": [...], "2D": [...]}`` as the 2D dataset expects
    (`model.py:344-383`).
    """
    section = pipeline_cfg["preprocess"][phase]
    if dimension == 3:
        return build_transform_list(3, section.get("3D"))
    return {
        "3D": build_transform_list(3, section.get("3D")),
        "2D": build_transform_list(2, section.get("2D")),
    }
