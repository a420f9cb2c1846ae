"""The program side of each model, one module a model, found by the
``model`` name of a configuration's file, as its plain twin under
``portbench/reference/`` is."""

from __future__ import annotations

import importlib


def lookup(config: dict):
    """(the program's module, the reference's module) of the
    configuration's model."""
    name = config["model"]
    return (importlib.import_module(f"portbench.programs.{name}"),
            importlib.import_module(f"portbench.reference.{name}"))
