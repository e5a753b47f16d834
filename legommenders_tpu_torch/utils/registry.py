"""Plugin registries for operators / predictors / inputers / processors /
embedders.

The port's own copy of the JAX package's utils/registry.py: torch classes
register here and never in the JAX registries.

Replaces the reference's glob-and-import ClassHub (loader/class_hub.py:43-177)
with explicit decorator registration plus the same lower-cased-name-minus-
suffix keying convention (`NAMLOperator` -> `naml`, `BertBaseOperator` ->
`bertbase`), so YAML `meta.item: CNN` style lookups resolve identically.
"""
from typing import Dict, Type


class Registry:
    def __init__(self, name: str, suffix: str = ""):
        self.name = name
        self.suffix = suffix
        self._classes: Dict[str, Type] = {}

    def key_of(self, cls) -> str:
        key = cls.__name__
        if self.suffix and key.lower().endswith(self.suffix.lower()):
            key = key[: -len(self.suffix)]
        return key.lower()

    def register(self, cls=None, *, key: str = None):
        def _do(c):
            k = (key or self.key_of(c)).lower()
            if k in self._classes and self._classes[k] is not c:
                raise ValueError(f"duplicate {self.name} registration: {k}")
            self._classes[k] = c
            return c

        if cls is None:
            return _do
        return _do(cls)

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._classes

    def __getitem__(self, key: str) -> Type:
        k = key.lower()
        if k not in self._classes:
            raise KeyError(
                f"unknown {self.name} '{key}'; known: {sorted(self._classes)}"
            )
        return self._classes[k]

    def get(self, key: str, default=None):
        return self._classes.get(key.lower(), default)

    def keys(self):
        return sorted(self._classes)

    def items(self):
        return sorted(self._classes.items())


# Global registries, populated by decorator at import time.
OPERATORS = Registry("operator", suffix="Operator")
PREDICTORS = Registry("predictor", suffix="Predictor")
PROCESSORS = Registry("processor", suffix="Processor")
INPUTERS = Registry("inputer", suffix="Inputer")
EMBEDDERS = Registry("embedder", suffix="Embedder")
