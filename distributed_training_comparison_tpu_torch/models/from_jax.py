"""Carry a JAX ``ViT``'s parameters across to the port.

``vit_from_jax`` takes the flax ``variables["params"]`` tree as nested
mappings of numpy arrays (the caller runs ``jax.device_get``; this module
imports no JAX) and returns the port ``ViT``'s ``state_dict``:

- the scanned trunk's leading ``depth`` axis splits into ``blocks.{i}``;
- dense kernels go (in, out) → (out, in), the patch-embed conv kernel
  HWIO → OIHW;
- LayerNorm ``scale`` becomes ``weight``.

Every leaf's shape is checked against the ViT its widths describe, and a
missing or left-over leaf raises, so a structural mismatch fails loudly
instead of half-converting.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DENSE = ("q_proj", "k_proj", "v_proj", "proj", "mlp_up", "mlp_down")


class VitPortError(ValueError):
    pass


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _expected_shapes(flat: dict[str, np.ndarray]) -> dict[str, tuple]:
    """Every leaf of the ViT whose widths ``flat`` declares, with its shape."""

    def leaf(key: str) -> np.ndarray:
        if key not in flat:
            raise VitPortError(f"JAX ViT params are missing {key!r}")
        return flat[key]

    pos = leaf("pos_emb")
    if pos.ndim != 3:
        raise VitPortError(f"'pos_emb' must be (1, S, dim), got {pos.shape}")
    tokens, dim = pos.shape[1:]
    depth = leaf("blocks/ln_attn/scale").shape[0]
    hidden = leaf("blocks/mlp_up/kernel").shape[-1]
    patch = leaf("patch_embed/kernel").shape[0]
    classes = leaf("head/kernel").shape[-1]
    shapes = {
        "pos_emb": (1, tokens, dim),
        "patch_embed/kernel": (patch, patch, 3, dim),
        "patch_embed/bias": (dim,),
        "ln_head/scale": (dim,),
        "ln_head/bias": (dim,),
        "head/kernel": (dim, classes),
        "head/bias": (classes,),
    }
    for ln in ("ln_attn", "ln_mlp"):
        shapes[f"blocks/{ln}/scale"] = shapes[f"blocks/{ln}/bias"] = (depth, dim)
    fan = {"mlp_up": (dim, hidden), "mlp_down": (hidden, dim)}
    for name in _DENSE:
        fin, fout = fan.get(name, (dim, dim))
        shapes[f"blocks/{name}/kernel"] = (depth, fin, fout)
        shapes[f"blocks/{name}/bias"] = (depth, fout)
    return shapes


def vit_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port ``ViT``'s ``state_dict`` from a JAX ViT ``params`` tree."""
    flat = _flatten(params)
    shapes = _expected_shapes(flat)
    missing = sorted(set(shapes) - set(flat))
    if missing:
        raise VitPortError(f"JAX ViT params are missing {missing}")
    leftover = sorted(set(flat) - set(shapes))
    if leftover:
        raise VitPortError(f"JAX params with no port counterpart: {leftover}")
    for key, shape in shapes.items():
        if flat[key].shape != shape:
            raise VitPortError(f"{key!r}: shape {flat[key].shape}, expected {shape}")

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a writable copy

    sd = {
        "pos_emb": t(flat["pos_emb"]),
        "patch_embed.weight": t(flat["patch_embed/kernel"].transpose(3, 2, 0, 1)),
        "patch_embed.bias": t(flat["patch_embed/bias"]),
        "ln_head.weight": t(flat["ln_head/scale"]),
        "ln_head.bias": t(flat["ln_head/bias"]),
        "head.weight": t(flat["head/kernel"].T),
        "head.bias": t(flat["head/bias"]),
    }
    for i in range(flat["blocks/ln_attn/scale"].shape[0]):
        for ln in ("ln_attn", "ln_mlp"):
            sd[f"blocks.{i}.{ln}.weight"] = t(flat[f"blocks/{ln}/scale"][i])
            sd[f"blocks.{i}.{ln}.bias"] = t(flat[f"blocks/{ln}/bias"][i])
        for name in _DENSE:
            sd[f"blocks.{i}.{name}.weight"] = t(flat[f"blocks/{name}/kernel"][i].T)
            sd[f"blocks.{i}.{name}.bias"] = t(flat[f"blocks/{name}/bias"][i])
    return sd
