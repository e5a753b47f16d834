"""YAML config system: `$$import` composition, `${var:default}$` interpolation,
CLI overrides and attribute-style access.

The port's copy of the JAX package's config/parser.py. The reference
resolves configs through the refconfig/smartdict/oba pip packages
(utils/config_init.py:20-62, config/model/naml.yaml:1-15); this is a
self-contained reimplementation of the observed semantics:

  * a YAML file may contain `$$import: [relative paths]`; imports are deep-
    merged in order, then the file's own keys override;
  * strings may embed `${name}`, `${name}$`, `${name:default}$` references.
    `name` resolves against (in order) the CLI/context mapping and a dotted
    path into the fully merged 4-axis config (`${data.base_dir}`);
  * a reference that is the entire string keeps the referent's type
    (`${hidden_size}$` -> int), otherwise it is substituted textually;
  * the 4 axes are `data` / `model` / `embed` / `exp` (trainer.py:299-313).

`yaml` is imported only when a file is read (utils/io.yaml_load).
"""
import os
import re
from typing import Any, Dict, Optional

from legommenders_tpu_torch.utils.function import infer_type
from legommenders_tpu_torch.utils.io import yaml_load

_REF = re.compile(r"\$\{([^}]+)\}\$?")


class Obj:
    """Attribute-style read access over nested dicts/lists (reference: oba.Obj)."""

    def __init__(self, data):
        object.__setattr__(self, "_data", data)

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict):
            return Obj(v)
        if isinstance(v, list):
            return [Obj._wrap(x) for x in v]
        return v

    def __getattr__(self, key):
        data = object.__getattribute__(self, "_data")
        if key in data:
            return Obj._wrap(data[key])
        return None

    def __getitem__(self, key):
        return self.__getattr__(key)

    def __contains__(self, key):
        return key in object.__getattribute__(self, "_data")

    def __iter__(self):
        return iter(object.__getattribute__(self, "_data"))

    def raw(self) -> dict:
        return object.__getattribute__(self, "_data")

    def __call__(self):
        return self.raw()

    def __repr__(self):
        return f"Obj({object.__getattribute__(self, '_data')!r})"


def deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_with_imports(path: str) -> dict:
    """Load a YAML file, resolving `$$import` lists recursively.

    Import paths are relative to the importing file's directory.
    """
    data = yaml_load(path) or {}
    if not isinstance(data, dict):
        return data
    imports = data.pop("$$import", None) or []
    if isinstance(imports, str):
        imports = [imports]
    merged: dict = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    for imp in imports:
        imp_path = imp if os.path.isabs(imp) else os.path.join(base_dir, imp)
        merged = deep_merge(merged, load_yaml_with_imports(imp_path))
    return deep_merge(merged, data)


def _lookup_dotted(tree: Any, dotted: str):
    cur = tree
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None, False
    return cur, True


class _Unresolved(Exception):
    pass


def _resolve_value(value: Any, context: Dict[str, Any], tree: Any):
    if isinstance(value, dict):
        # keys interpolate too (`- title@${lm}: 30` in item.inputs arrives
        # as {"title@${lm}": 30}); a resolved key must stay a string
        out = {}
        for k, v in value.items():
            rk = _resolve_value(k, context, tree) if isinstance(k, str) else k
            if not isinstance(rk, str) and rk is not None:
                rk = str(rk)
            out[rk if rk is not None else k] = _resolve_value(v, context, tree)
        return out
    if isinstance(value, list):
        return [_resolve_value(v, context, tree) for v in value]
    if not isinstance(value, str):
        return value

    matches = list(_REF.finditer(value))
    if not matches:
        return value

    def lookup(expr: str):
        if ":" in expr:
            name, default = expr.split(":", 1)
            default = infer_type(default)
            has_default = True
        else:
            name, default, has_default = expr, None, False
        if name in context:
            return context[name]
        v, ok = _lookup_dotted(tree, name)
        if ok:
            return _resolve_value(v, context, tree)
        if has_default:
            return default
        raise _Unresolved(f"unresolved config reference ${{{name}}}")

    # whole-string reference: preserve type
    m = matches[0]
    if len(matches) == 1 and m.start() == 0 and value[m.end():] in ("", "$"):
        return lookup(m.group(1))

    def sub(m):
        v = lookup(m.group(1))
        return "" if v is None else str(v)

    out = _REF.sub(sub, value)
    # trailing `$` of the `${..}$` form is consumed by the regex's optional $
    return out


def resolve(tree: dict, context: Optional[Dict[str, Any]] = None,
            max_passes: int = 8) -> dict:
    """Iteratively resolve references (values may reference other resolved
    values, e.g. data.base_dir)."""
    context = context or {}
    cur = tree
    for _ in range(max_passes):
        nxt = _resolve_value(cur, context, cur)
        if nxt == cur:
            return nxt
        cur = nxt
    return cur


def load_config(path: str, context: Optional[Dict[str, Any]] = None) -> dict:
    return resolve(load_yaml_with_imports(path), context)


def load_axis_config(path: str, axis: str,
                     context: Optional[Dict[str, Any]] = None) -> dict:
    """Load ONE axis file standalone, resolving self-references like
    `${data.base_dir}` by wrapping it under its axis key the way
    parse_four_way would."""
    tree = resolve({axis: load_yaml_with_imports(path)}, context)
    return tree[axis]


def _find_config(axis: str, name_or_path: str, config_root: str = "config") -> Optional[str]:
    """Map a CLI value like `mind` to `config/data/mind.yaml`, or accept a
    direct path."""
    if name_or_path is None:
        return None
    if os.path.isfile(name_or_path):
        return name_or_path
    cand = os.path.join(config_root, axis, f"{name_or_path}.yaml")
    if os.path.isfile(cand):
        return cand
    # cross-axis trees like `--data recbench/mind` -> config/recbench/mind.yaml
    alt = os.path.join(config_root, f"{name_or_path}.yaml")
    if os.path.isfile(alt):
        return alt
    raise FileNotFoundError(
        f"no {axis} config named {name_or_path!r} (tried {cand}, {alt})")


def parse_four_way(cli: Dict[str, Any], config_root: str = "config") -> Obj:
    """Build the merged 4-axis configuration from CLI args.

    `--data mind --model naml --embed glove --exp default --hidden_size 64 ...`
    Extra CLI keys become interpolation context AND dotted-path overrides
    (`--exp.policy.lr 0.01`).
    """
    axes = {}
    for axis in ("data", "model", "embed", "exp"):
        path = _find_config(axis, cli.get(axis), config_root) if cli.get(axis) else None
        axes[axis] = load_yaml_with_imports(path) if path else {}

    context = {k: v for k, v in cli.items()
               if k not in ("data", "model", "embed", "exp")}

    # dotted-path CLI overrides onto the tree; intermediate dicts are
    # created so an override can never be silently dropped (only a
    # non-dict intermediate aborts, loudly)
    tree = dict(axes)
    for key, value in list(context.items()):
        if "." in key:
            parts = key.split(".")
            cur = tree
            for part in parts[:-1]:
                if part not in cur:
                    cur[part] = {}
                cur = cur[part]
                if not isinstance(cur, dict):
                    raise ValueError(
                        f"cannot apply override --{key}: "
                        f"'{part}' is not a mapping")
            cur[parts[-1]] = value

    resolved = resolve(tree, context)
    return Obj(resolved)
