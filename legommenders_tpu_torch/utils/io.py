"""Small IO helpers (json/jsonl/yaml).

The port's copy of the JAX package's utils/io.py JSON and YAML helpers.
`yaml` is imported inside `yaml_load` and `yaml_save` only, so that a
machine without PyYAML can import the port.
"""
import json
import os

import numpy as np


def json_load(path):
    with open(path, "r") as f:
        return json.load(f)


def json_save(obj, path, indent=2):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent, default=_default)


def _default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not json-serializable: {type(o)}")


def jsonl_load(path):
    with open(path, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def jsonl_append(obj, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(obj, default=_default) + "\n")


def yaml_load(path):
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def yaml_save(obj, path):
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
