"""Seeding, config merging, CLI parsing and experiment signatures.

The port's copy of the JAX package's utils/function.py (reference
utils/function.py): `seeding`, `combine_config` (defaults merge), a minimal
`--k v` argparser with type inference, and the 8-char b64(md5(sorted-JSON))
experiment signature.
"""
import base64
import hashlib
import json
import random
from typing import Any, Dict, List

import numpy as np
import torch


def seeding(seed: int = 2023):
    """Pin python's, numpy's and torch's global generators. The port's own
    randomness (weight init, dropout, negative sampling) draws from
    explicit generators made from the run's seed; this covers what a
    library draws from the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def infer_type(value: str) -> Any:
    """Type inference for CLI values: int, float, bool, null, str."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def parse_cli(argv: List[str]) -> Dict[str, Any]:
    """Minimal `--key value` parser with type inference.

    Supports `--flag` (bool true) and dotted keys (`--policy.lr 0.01`).
    """
    out: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        token = argv[i]
        if not token.startswith("--"):
            raise ValueError(f"expected --key, got {token!r}")
        key = token[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            out[key] = infer_type(argv[i + 1])
            i += 2
        else:
            out[key] = True
            i += 1
    return out


def combine_config(config: dict, **defaults) -> dict:
    """Fill missing keys of `config` with defaults (non-recursive),
    mirroring the reference's combine_config."""
    out = dict(defaults)
    out.update({k: v for k, v in (config or {}).items() if v is not None})
    return out


def get_signature(*configs: dict) -> str:
    """8-char url-safe b64 of md5 over the sorted JSON of the configs."""
    blob = json.dumps(configs, sort_keys=True, default=str)
    digest = hashlib.md5(blob.encode()).digest()
    return base64.urlsafe_b64encode(digest).decode()[:8]


def get_random_string(length: int = 6) -> str:
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    return "".join(random.choice(alphabet) for _ in range(length))
