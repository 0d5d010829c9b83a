"""Carry a JAX ``ViT``'s parameters across to the port.

``vit_from_jax`` takes the flax ``variables["params"]`` tree as nested
mappings of numpy arrays (the caller runs ``jax.device_get``; this module
imports no JAX) and returns the port ``ViT``'s ``state_dict``:

- the scanned trunk's leading ``depth`` axis splits into ``blocks.{i}``;
- dense kernels go (in, out) → (out, in), the patch-embed conv kernel
  HWIO → OIHW;
- LayerNorm ``scale`` becomes ``weight``;
- an MoE trunk (``blocks/moe``) has no ``mlp_up``/``mlp_down``: its router
  kernel goes (in, out) → (out, in) like a dense kernel, and the expert
  stacks ``w_up``, ``b_up``, ``w_down``, ``b_down`` keep their JAX layouts.

Every leaf's shape is checked against the ViT its widths describe, and a
missing or left-over leaf raises, so a structural mismatch fails loudly
instead of half-converting.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_DENSE = ("q_proj", "k_proj", "v_proj", "proj", "mlp_up", "mlp_down")
_EXPERTS = ("w_up", "b_up", "w_down", "b_down")


def _dense_names(flat: dict) -> tuple[str, ...]:
    """The trunk's dense layers: an MoE trunk has no MLP pair."""
    return _DENSE[:4] if "blocks/moe/w_up" in flat else _DENSE


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
    moe = "blocks/moe/w_up" in flat
    hidden = leaf("blocks/moe/w_up" if moe else "blocks/mlp_up/kernel").shape[-1]
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
    for name in _dense_names(flat):
        fin, fout = fan.get(name, (dim, dim))
        shapes[f"blocks/{name}/kernel"] = (depth, fin, fout)
        shapes[f"blocks/{name}/bias"] = (depth, fout)
    if moe:
        experts = flat["blocks/moe/w_up"].shape[1]
        shapes.update({
            "blocks/moe/router/kernel": (depth, dim, experts),
            "blocks/moe/router/bias": (depth, experts),
            "blocks/moe/w_up": (depth, experts, dim, hidden),
            "blocks/moe/b_up": (depth, experts, hidden),
            "blocks/moe/w_down": (depth, experts, hidden, dim),
            "blocks/moe/b_down": (depth, experts, dim),
        })
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
        for name in _dense_names(flat):
            sd[f"blocks.{i}.{name}.weight"] = t(flat[f"blocks/{name}/kernel"][i].T)
            sd[f"blocks.{i}.{name}.bias"] = t(flat[f"blocks/{name}/bias"][i])
        if "blocks/moe/w_up" in flat:
            sd[f"blocks.{i}.moe.router.weight"] = t(flat["blocks/moe/router/kernel"][i].T)
            sd[f"blocks.{i}.moe.router.bias"] = t(flat["blocks/moe/router/bias"][i])
            for name in _EXPERTS:
                sd[f"blocks.{i}.moe.{name}"] = t(flat[f"blocks/moe/{name}"][i])
    return sd
