"""Config merging (the port's copy of the JAX package's
utils/function.combine_config)."""


def combine_config(config: dict, **defaults) -> dict:
    """Fill missing keys of `config` with defaults (non-recursive),
    mirroring the reference's combine_config."""
    out = dict(defaults)
    out.update({k: v for k, v in (config or {}).items() if v is not None})
    return out
