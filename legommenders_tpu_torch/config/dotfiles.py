"""Dotfile registries: name -> path mappings for datasets, LM checkpoints
and auth tokens.

The port's copy of the JAX package's config/dotfiles.py (reference
utils/config_init.py:65-201) — `.data`, `.model` and
`.auth` files map short names (e.g. `bertbase`, `mind`) to local paths /
secrets. Files are YAML (or `key = value` lines) looked up in the repo
root then the user home. `yaml` is imported only when a dotfile is read.
"""
import os
from typing import Dict, Optional


def _parse(path: str) -> Dict[str, str]:
    import yaml

    with open(path, "r") as f:
        text = f.read()
    try:
        data = yaml.safe_load(text)
        if isinstance(data, dict):
            return {str(k): str(v) for k, v in data.items()}
    except yaml.YAMLError:
        pass
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out


class DotfileRegistry:
    filename: str = ".data"

    def __init__(self):
        self._cache: Optional[Dict[str, str]] = None

    def _load(self) -> Dict[str, str]:
        if self._cache is None:
            merged: Dict[str, str] = {}
            for base in (os.path.expanduser("~"), os.getcwd()):
                path = os.path.join(base, self.filename)
                if os.path.isfile(path):
                    merged.update(_parse(path))
            self._cache = merged
        return self._cache

    def get(self, name: str, default: Optional[str] = None,
            required: bool = False) -> Optional[str]:
        value = self._load().get(name, default)
        if required and value is None:
            raise KeyError(
                f"'{name}' not found in {self.filename} (searched repo root "
                f"and home); add a line `{name}: /path`")
        return value

    def reload(self):
        self._cache = None
        return self


class _DataInit(DotfileRegistry):
    filename = ".data"


class _ModelInit(DotfileRegistry):
    filename = ".model"


class _AuthInit(DotfileRegistry):
    filename = ".auth"


DataInit = _DataInit()
ModelInit = _ModelInit()
AuthInit = _AuthInit()
