"""JAX parameter tree → the port's `state_dict`, with numpy only.

Counterpart of `cips3d_tpu/utils/convert_torch.py::export_generator_state_dict`:
the port's modules use the reference's state-dict layout, so a tree of the
JAX package (nested dicts of arrays, e.g. from a ``G_ema.npz`` snapshot)
maps onto it key by key:

  * flax kernel (in, out) → torch Linear weight (out, in);
  * SinStyleMod weight (in, out) → (1, in, out), plus the identity affine of
    its unused LayerNorm;
  * LayerNorm scale/bias → weight/bias;
  * ``siren/film_{i}`` → ``siren.network.{i}``, ``siren/sigma`` →
    ``siren.final_layer``, ``color_film`` → ``color_layer_sine``,
    ``color_linear`` → ``color_layer_linear.0``;
  * mapping ``base_{i}``/``base_norm_{i}``/``norm_out`` → ``base_net.{slot}``;
  * ``inr_net/block_{res}`` → ``inr_net.network.{res}``, ``to_rgb_{res}`` →
    ``inr_net.to_rgbs.{res}`` (zero placeholders for the heads the JAX
    model never creates), ``out_linear`` → ``inr_net.tanh.0``;
  * ``aux_to_rgb`` → ``aux_to_rbg.0``.

The discriminator's tree (``d_params``) maps onto the port's
`DiscriminatorMultiScaleAux` the same way: ``conv_in_{res}`` →
``conv_in.{res}``, ``res_{res}`` → ``blocks.{res}``, equalized-lr linear
kernels (in, out) → weights (out, in); conv weights are OIHW in both.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(dst: dict, tree: dict, name: str):
    dst[f"{name}.weight"] = _np(tree["kernel"]).T.copy()
    if "bias" in tree:
        dst[f"{name}.bias"] = _np(tree["bias"]).copy()


def _layernorm(dst: dict, tree: dict, name: str):
    dst[f"{name}.weight"] = _np(tree["scale"]).copy()
    dst[f"{name}.bias"] = _np(tree["bias"]).copy()


def _film(dst: dict, tree: dict, name: str):
    for part in ("linear", "gain_fc", "bias_fc"):
        _linear(dst, tree[part], f"{name}.{part}")


def _sinstylemod(dst: dict, tree: dict, name: str):
    w = _np(tree["weight"])
    dst[f"{name}.weight"] = w[None].copy()
    _linear(dst, tree["modulation"], f"{name}.modulation")
    dst[f"{name}.norm.weight"] = np.ones((w.shape[0],), np.float32)
    dst[f"{name}.norm.bias"] = np.zeros((w.shape[0],), np.float32)


def mapping_state_dict(tree: dict) -> Dict[str, np.ndarray]:
    """A mapping network's tree → ``base_net.{slot}`` keys, rebuilding the
    Sequential's slot indices (Linear [, LayerNorm], LeakyReLU per layer)."""
    out: Dict[str, np.ndarray] = {}
    base_layers = sum(1 for k in tree if k.startswith("base_") and not k.startswith("base_norm"))
    add_norm = "base_norm_0" in tree
    slot = 0
    for i in range(base_layers):
        _linear(out, tree[f"base_{i}"], f"base_net.{slot}")
        slot += 1
        if i != base_layers - 1:
            if add_norm:
                _layernorm(out, tree[f"base_norm_{i}"], f"base_net.{slot}")
                slot += 1
            slot += 1  # LeakyReLU
    if "norm_out" in tree:
        _layernorm(out, tree["norm_out"], f"base_net.{slot}")
    return out


def siren_state_dict(siren: dict) -> Dict[str, np.ndarray]:
    """A `NeRFNetwork` tree → its state dict."""
    sd: Dict[str, np.ndarray] = {}
    films = sorted((k for k in siren if k.startswith("film_")), key=lambda k: int(k.split("_")[1]))
    for i, k in enumerate(films):
        _film(sd, siren[k], f"network.{i}")
    _linear(sd, siren["sigma"], "final_layer")
    _film(sd, siren["color_film"], "color_layer_sine")
    _linear(sd, siren["color_linear"], "color_layer_linear.0")
    return sd


def inr_state_dict(inr: dict) -> Dict[str, np.ndarray]:
    """A `CIPSNet` tree → its state dict, with zero placeholders for the
    ToRGB heads the reference builds but never uses."""
    sd: Dict[str, np.ndarray] = {}
    out_dim = next((_np(inr[k]["linear"]["kernel"]).shape[1]
                    for k in inr if k.startswith("to_rgb_")), 3)
    for k in inr:
        if k.startswith("block_"):
            res = k[len("block_"):]
            _sinstylemod(sd, inr[k]["mod1"], f"network.{res}.mod1")
            _sinstylemod(sd, inr[k]["mod2"], f"network.{res}.mod2")
            if f"to_rgb_{res}" not in inr:
                hidden = _np(inr[k]["mod1"]["weight"]).shape[1]
                sd[f"to_rgbs.{res}.linear.weight"] = np.zeros((out_dim, hidden), np.float32)
                sd[f"to_rgbs.{res}.linear.bias"] = np.zeros((out_dim,), np.float32)
        elif k.startswith("to_rgb_"):
            _linear(sd, inr[k]["linear"], f"to_rgbs.{k[len('to_rgb_'):]}.linear")
    if "out_linear" in inr:
        _linear(sd, inr["out_linear"], "tanh.0")
    return sd


def _prefixed(prefix: str, sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """JAX generator params ({"params": {...}} or the inner dict) → the
    port's `GeneratorNerfINR` state dict (numpy values)."""
    p = params.get("params", params)
    sd = _prefixed("siren", siren_state_dict(p["siren"]))
    sd.update(_prefixed("mapping_network_nerf", mapping_state_dict(p["mapping_network_nerf"])))
    sd.update(_prefixed("mapping_network_inr", mapping_state_dict(p["mapping_network_inr"])))
    sd.update(_prefixed("inr_net", inr_state_dict(p["inr_net"])))
    _linear(sd, p["aux_to_rgb"], "aux_to_rbg.0")
    return sd


def _disc_tree(dst: dict, tree: dict, name: str):
    for k, v in tree.items():
        if k.startswith("conv_in_"):
            key = f"{name}conv_in.{k[len('conv_in_'):]}"
        elif k.startswith("res_"):
            key = f"{name}blocks.{k[len('res_'):]}"
        else:
            key = f"{name}{k}"
        if isinstance(v, dict):
            _disc_tree(dst, v, key + ".")
        elif k == "kernel":
            dst[f"{name}weight"] = _np(v).T.copy()
        else:
            dst[key] = _np(v).copy()


def discriminator_state_dict(d_params: dict) -> Dict[str, np.ndarray]:
    """JAX discriminator params ({"params": {...}} or the inner dict) → the
    port's `DiscriminatorMultiScale(Aux)` state dict (numpy values)."""
    sd: Dict[str, np.ndarray] = {}
    _disc_tree(sd, d_params.get("params", d_params), "")
    return sd


def load_jax_d_params(model, d_params: dict) -> None:
    """Load a JAX discriminator tree into a port discriminator (strict)."""
    model.load_state_dict(to_torch(discriminator_state_dict(d_params)), strict=True)


def to_torch(sd: Dict[str, np.ndarray]):
    """numpy state dict → torch tensors, for `load_state_dict`."""
    import torch

    return {k: torch.from_numpy(v) for k, v in sd.items()}


def load_jax_params(model, params: dict) -> None:
    """Load a JAX parameter tree into a port `GeneratorNerfINR` (strict)."""
    model.load_state_dict(to_torch(state_dict_from_jax(params)), strict=True)


def load_jax_train_state(state, g_params: dict, d_params: dict, ema_params: dict = None,
                         step: int = 0) -> None:
    """Load the G, D and EMA trees and the step counter of a JAX
    `TrainState` into a port `TrainState` (Adam's moments start afresh)."""
    load_jax_params(state.generator, g_params)
    load_jax_d_params(state.discriminator, d_params)
    load_jax_params(state.ema, g_params if ema_params is None else ema_params)
    state.step = int(step)
