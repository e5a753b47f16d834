"""LM layer-split caching: the lower slice's hidden states for every item.

The port of the JAX package's runtime/lm_cache.py:30-185 (reference
once_operator.py:101-134, loader/pager/lm_layer_pager.py and, for IISAN,
iisan_operator.py:115-151). The frozen lower `tune_from` layers run once
over every item, page by page on the device under torch.no_grad() at
dropout 0; the (N, L, D)
hidden states and (N, L) masks stay on the device as content columns
(LM_HIDDEN_KEY / LM_MASK_KEY) that the train step gathers from.

On disk (optional) the cache is f32 in JAX's layout, cache/<data>/<op>/,
under names the JAX package never writes: torch_layer_<k>.<sig>.npy and
torch_mask.<sig>.npy, keyed by a fingerprint of the item operator's
weights, its output-affecting knobs and the contents' shapes (so that a
catalog of another size under the same data name builds its own). Rows with NaNs are replaced by
random values and their mask reduced to the first position (reference
once_operator.py:118-123). On the device the token dim is padded to a
multiple of 8 with mask 0 (JAX :141-152): L = 34 becomes 40, so the upper
slice packs 3 items into T = 120, as in JAX; L = 31 (a decoder's title +
category) becomes 32, T = 128. Built on the device, the pages are written
into one buffer of the padded shape, and the NaN scrub reads it a block
of rows at a time: the Llama-7B geometry's cache is 17 GB, and a second
copy of it (a concatenation, a pad) would not fit beside the model.

IISAN (`load_or_build_iisan_cache`): the frozen LM's per-layer pooled
states (N, num_hidden_layers, D) are built in f32 once, page by page into
one buffer, NaN rows scrubbed, and kept on disk (optional) as
<op>iisan/torch_states.<sig>.npy; only the selected layers (N, H_sel, D)
stay on the device, under LM_HIDDEN_KEY, with an (N, 1) mask of ones.
"""
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from legommenders_tpu_torch.models.operators.lm_ops import (
    LM_HIDDEN_KEY, LM_MASK_KEY,
)

TOKEN_ALIGN = 8


def cache_dir(data_name: str, operator_name: str, root: str = "cache") -> str:
    return os.path.join(root, data_name, operator_name)


def weights_fingerprint(module: torch.nn.Module, extra: str = "") -> str:
    """Short digest of a module's parameter values (the first 8 values of
    each tensor, by name), with `extra` folded in."""
    h = hashlib.md5()
    h.update(extra.encode())
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().reshape(-1)[:8].float().cpu().numpy().tobytes())
    return h.hexdigest()[:10]


def arch_key(op) -> str:
    """Output-affecting knobs of the item operator that its weights do not
    capture (JAX lm_cache.arch_key)."""
    dt = str(getattr(op, "lm_dtype", torch.float32)).replace("torch.", "")
    return (f"gelu_approx={bool(getattr(op, 'gelu_approximate', False))},"
            f"lm_dtype={dt},"
            f"fused_qkv={bool(getattr(op, 'fused_qkv', False))}")


def contents_key(contents: Dict[str, torch.Tensor]) -> str:
    """The content columns' names and shapes, for the cache's key."""
    return ",".join(f"{c}={tuple(a.shape)}"
                    for c, a in sorted(contents.items()))


def scrub_nans(hidden: torch.Tensor, mask: Optional[torch.Tensor],
               seed: int = 0, rows: int = 4096):
    """Rows with a NaN get random values in [0, 1) (drawn in row order);
    an item with such a row keeps only its first position in the mask (if
    one is given). In place, `rows` items at a time."""
    rng = np.random.default_rng(seed)
    for s in range(0, hidden.shape[0], rows):
        block = hidden[s:s + rows]
        nan_pos = torch.isnan(block).any(dim=-1)
        if not bool(nan_pos.any()):
            continue
        n = int(nan_pos.sum())
        block[nan_pos] = torch.as_tensor(
            rng.random((n, hidden.shape[-1])), dtype=hidden.dtype,
            device=hidden.device)
        if mask is not None:
            block_mask = mask[s:s + rows]
            nan_item = nan_pos.any(dim=-1)
            block_mask[nan_item] = 0
            block_mask[nan_item, 0] = 1
    return hidden, mask


@torch.no_grad()
def build_lm_hidden(model, contents: Dict[str, torch.Tensor],
                    page_size: int = 256,
                    align: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lower slice over every item, `page_size` items at a time on the
    contents' device, each page written into one buffer: (hidden (N, L',
    D) in the slice's dtype, mask (N, L') int32), L' the slice's L rounded
    up to a multiple of `align` (zeros, mask 0), NaNs scrubbed."""
    n = next(iter(contents.values())).shape[0]
    hidden = mask = None
    for s in range(0, n, page_size):
        h, m = model.encode_item_lower(
            {c: a[s:s + page_size] for c, a in contents.items()})
        if hidden is None:
            L = h.shape[1]
            padded = -(-L // align) * align
            hidden = h.new_zeros((n, padded, h.shape[2]))
            mask = torch.zeros((n, padded), dtype=torch.int32,
                               device=h.device)
        hidden[s:s + len(h), :L] = h
        mask[s:s + len(h), :L] = m.to(torch.int32)
    return scrub_nans(hidden, mask)


def device_entries(hidden: torch.Tensor, mask: torch.Tensor,
                   dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """{LM_HIDDEN_KEY, LM_MASK_KEY} on `device`, the hidden states in
    `dtype`, the token dim padded to a multiple of TOKEN_ALIGN (mask 0);
    tensors already so are taken as they are."""
    pad = (-hidden.shape[1]) % TOKEN_ALIGN
    hidden = hidden.to(device=device, dtype=dtype)
    mask = mask.to(device=device, dtype=torch.int32)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    return {LM_HIDDEN_KEY: hidden.contiguous(), LM_MASK_KEY: mask}


def load_or_build_lm_cache(model, contents: Dict[str, torch.Tensor],
                           data_name: str, operator_name: str, layer: int,
                           page_size: int = 256,
                           root: Optional[str] = "cache",
                           device_dtype: torch.dtype = torch.float32,
                           ) -> Dict[str, torch.Tensor]:
    """The cache's content columns on the contents' device. With `root`,
    the f32 cache files there are read if present or built and written;
    with root None the cache is built on the device and nothing is
    written."""
    device = next(iter(contents.values())).device
    if root is None:
        hidden, mask = build_lm_hidden(model, contents, page_size,
                                       align=TOKEN_ALIGN)
        return device_entries(hidden, mask, device_dtype, device)
    sig = weights_fingerprint(model.item_op, extra=arch_key(model.item_op)
                              + contents_key(contents))
    d = cache_dir(data_name, operator_name, root)
    hpath = os.path.join(d, f"torch_layer_{layer}.{sig}.npy")
    mpath = os.path.join(d, f"torch_mask.{sig}.npy")
    if os.path.isfile(hpath) and os.path.isfile(mpath):
        hidden = torch.from_numpy(np.load(hpath))
        mask = torch.from_numpy(np.load(mpath))
    else:
        hidden, mask = build_lm_hidden(model, contents, page_size)
        os.makedirs(d, exist_ok=True)
        np.save(hpath, hidden.float().cpu().numpy())
        np.save(mpath, mask.cpu().numpy())
    return device_entries(hidden, mask, device_dtype, device)


@torch.no_grad()
def build_iisan_states(model, contents: Dict[str, torch.Tensor],
                       page_size: int = 256) -> torch.Tensor:
    """The IISAN operator's frozen LM over every item, `page_size` items at
    a time on the contents' device, each page's per-layer pooled states
    written into one f32 buffer (N, num_hidden_layers, D), NaNs
    scrubbed."""
    n = next(iter(contents.values())).shape[0]
    states = None
    for s in range(0, n, page_size):
        pooled, _ = model.encode_item_lower(
            {c: a[s:s + page_size] for c, a in contents.items()})
        if states is None:
            states = torch.empty((n,) + tuple(pooled.shape[1:]),
                                 dtype=torch.float32, device=pooled.device)
        states[s:s + len(pooled)] = pooled
    return scrub_nans(states, None)[0]


def load_or_build_iisan_cache(model, contents: Dict[str, torch.Tensor],
                              data_name: str, operator_name: str,
                              selected_layers, page_size: int = 256,
                              root: Optional[str] = "cache",
                              ) -> Dict[str, torch.Tensor]:
    """The IISAN cache's content columns on the contents' device (JAX
    lm_cache.py:157-185): the selected layers' states (N, H_sel, D) f32
    under LM_HIDDEN_KEY and an (N, 1) mask of ones under LM_MASK_KEY. With
    `root`, the f32 all-layer states are read from
    <root>/<data>/<op>iisan/ if present, else built and written there;
    with root None they are built on the device and nothing is written."""
    device = next(iter(contents.values())).device
    states = None
    if root is not None:
        sig = weights_fingerprint(model.item_op,
                                  extra=arch_key(model.item_op)
                                  + contents_key(contents))
        d = cache_dir(data_name, f"{operator_name}iisan", root)
        spath = os.path.join(d, f"torch_states.{sig}.npy")
        if os.path.isfile(spath):
            states = torch.from_numpy(np.load(spath))
            scrub_nans(states, None)
    if states is None:
        states = build_iisan_states(model, contents, page_size)
        if root is not None:
            os.makedirs(d, exist_ok=True)
            np.save(spath, states.cpu().numpy())
    sel = states[:, list(selected_layers)].to(device).contiguous()
    del states
    return {LM_HIDDEN_KEY: sel,
            LM_MASK_KEY: torch.ones((sel.shape[0], 1), dtype=torch.int32,
                                    device=device)}
