"""The reference's generator checkpoints (``.pth``), read and written:
counterpart of `cips3d_tpu/utils/convert_torch.py`.

The reference releases G_ema checkpoints (FFHQ_r256, AFHQ, CartoonFaces) as
state dicts of its `GeneratorNerfINR`, whose key layout the port's modules
share (``siren.network.{i}``, ``inr_net.network.{res}.mod{1,2}``,
``inr_net.to_rgbs.{res}``, mapping ``base_net.{slot}``, ``aux_to_rbg.0``).

  * `load_torch_checkpoint`, `convert_generator_state_dict`,
    `convert_generator_checkpoint`: a ``.pth`` → the JAX package's param
    tree, key for key (numpy f32), as the JAX functions give it: a
    ``to_rgb_{res}`` for every block, dead heads included; the ``to_rbgs``
    spelling of some dev variants; ``inr_net.tanh.0`` → ``out_linear``;
  * `export_generator_state_dict`, `save_torch_checkpoint`,
    `export_reference_checkpoint_dir`: a JAX tree (or a port generator) →
    a ``.pth`` or the reference's directory of ``<name>_model.pth`` files;
  * `load_reference_generator`: a ``.pth`` → a port `GeneratorNerfINR`
    through a strict ``load_state_dict``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from cips3d_tpu_torch.utils.convert import (_t, _unfilm, _unlinear, state_dict_from_jax,
                                            to_torch)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A state-dict ``.pth`` → numpy arrays; a ``{"state_dict": ...}``
    wrapper is unwrapped when no top-level key is a generator's."""
    import torch

    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd and not any(
        k.startswith(("siren", "inr_net")) for k in sd
    ):
        sd = sd["state_dict"]
    return {k: v.detach().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def _unlayernorm(sd: dict, name: str) -> dict:
    return {"scale": _t(sd[f"{name}.weight"]).copy(), "bias": _t(sd[f"{name}.bias"]).copy()}


def _mapping(sd: dict, prefix: str, base_layers: int, add_norm: bool, norm_out: bool) -> dict:
    """The ``base_net`` Sequential's slots of ``base_layers`` layers: Linear
    [, LayerNorm], LeakyReLU each, the last one Linear only, then the
    ``norm_out`` LayerNorm."""
    out: dict = {}
    slot = 0
    for i in range(base_layers):
        out[f"base_{i}"] = _unlinear(sd, f"{prefix}.base_net.{slot}")
        slot += 1
        if i != base_layers - 1:
            if add_norm:
                out[f"base_norm_{i}"] = _unlayernorm(sd, f"{prefix}.base_net.{slot}")
                slot += 1
            slot += 1   # LeakyReLU
    if norm_out:
        out["norm_out"] = _unlayernorm(sd, f"{prefix}.base_net.{slot}")
    return out


def convert_generator_state_dict(
    sd: Dict[str, np.ndarray],
    nerf_hidden_layers: int = 2,
    nerf_mapping_layers: int = 4,
    inr_mapping_layers: int = 8,
) -> dict:
    """A reference `GeneratorNerfINR` state dict → the JAX generator's
    params ``{"params": {...}}`` (numpy f32)."""
    siren = {f"film_{i}": _unfilm(sd, f"siren.network.{i}") for i in range(nerf_hidden_layers)}
    siren["sigma"] = _unlinear(sd, "siren.final_layer")
    siren["color_film"] = _unfilm(sd, "siren.color_layer_sine")
    siren["color_linear"] = _unlinear(sd, "siren.color_layer_linear.0")

    inr: dict = {}
    resolutions = sorted({k.split(".")[2] for k in sd if k.startswith("inr_net.network.")},
                         key=int)
    rgb_attr = "to_rgbs" if any(k.startswith("inr_net.to_rgbs.") for k in sd) else "to_rbgs"
    for res in resolutions:
        inr[f"block_{res}"] = {
            m: {"weight": _t(sd[f"inr_net.network.{res}.{m}.weight"])[0].copy(),
                "modulation": _unlinear(sd, f"inr_net.network.{res}.{m}.modulation")}
            for m in ("mod1", "mod2")}
        inr[f"to_rgb_{res}"] = {"linear": _unlinear(sd, f"inr_net.{rgb_attr}.{res}.linear")}
    if "inr_net.tanh.0.weight" in sd:
        inr["out_linear"] = _unlinear(sd, "inr_net.tanh.0")

    return {"params": {
        "siren": siren,
        "mapping_network_nerf": _mapping(sd, "mapping_network_nerf", nerf_mapping_layers,
                                         add_norm=False, norm_out=False),
        "mapping_network_inr": _mapping(sd, "mapping_network_inr", inr_mapping_layers,
                                        add_norm=True, norm_out=True),
        "inr_net": inr,
        "aux_to_rgb": _unlinear(sd, "aux_to_rbg.0"),
    }}


def convert_generator_checkpoint(path: str, **kwargs) -> dict:
    return convert_generator_state_dict(load_torch_checkpoint(path), **kwargs)


def export_generator_state_dict(params: dict, rgb_attr: str = "to_rgbs") -> Dict[str, np.ndarray]:
    """JAX generator params ({"params": {...}} or the inner dict) → the
    reference `GeneratorNerfINR` state dict (numpy), with the identity
    LayerNorms and zero ToRGB heads the JAX model lacks; ``rgb_attr`` names
    the RGB heads (``to_rbgs`` in some dev variants)."""
    sd = state_dict_from_jax(params)
    if rgb_attr == "to_rgbs":
        return sd
    old = "inr_net.to_rgbs."
    return {(f"inr_net.{rgb_attr}." + k[len(old):] if k.startswith(old) else k): v
            for k, v in sd.items()}


def generator_state_dict(G) -> Dict[str, np.ndarray]:
    """A port generator (its state dict as it is, dead heads included) or
    a JAX param tree (`export_generator_state_dict`) → numpy state dict."""
    if hasattr(G, "state_dict"):
        return {k: _numpy(v) for k, v in G.state_dict().items()}
    return export_generator_state_dict(G)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def save_torch_checkpoint(sd: Dict[str, np.ndarray], path: str):
    """Write a state dict (numpy or torch values) as a ``.pth`` the
    reference loads."""
    import torch

    torch.save({k: torch.from_numpy(np.ascontiguousarray(_numpy(v))) for k, v in sd.items()},
               path)


def export_reference_checkpoint_dir(
    out_dir: str,
    G_ema,
    generator=None,
    info_msg: str = "",
    **extra_models: dict,
):
    """The reference's directory-of-modules checkpoint: ``G_ema_model.pth``,
    ``generator_model.pth`` (when given), ``<name>_model.pth`` for each
    extra state dict (e.g. a discriminator) and ``info.txt``.
    ``G_ema``/``generator`` are JAX param trees or port generators."""
    os.makedirs(out_dir, exist_ok=True)
    save_torch_checkpoint(generator_state_dict(G_ema), os.path.join(out_dir, "G_ema_model.pth"))
    if generator is not None:
        save_torch_checkpoint(generator_state_dict(generator),
                              os.path.join(out_dir, "generator_model.pth"))
    for name, sd in extra_models.items():
        save_torch_checkpoint(sd, os.path.join(out_dir, f"{name}_model.pth"))
    with open(os.path.join(out_dir, "info.txt"), "w") as f:
        f.write(info_msg + "\n")


def load_reference_generator(path: str, cfg=None, device="cuda"):
    """A port `GeneratorNerfINR` of ``cfg`` (default `GeneratorConfig()`,
    the released checkpoints' architecture) with the weights of the
    reference ``.pth`` at ``path``, on ``device``, in eval mode.  The
    ``to_rbgs`` spelling is read as ``to_rgbs``; the unused SinStyleMod
    LayerNorms and dead ToRGB heads, when absent, are filled as
    `utils/convert.py` fills them (identity, zeros).  Missing or unexpected
    keys raise a KeyError that names them."""
    from cips3d_tpu_torch.models.generator import GeneratorConfig, GeneratorNerfINR

    sd = {k.replace("inr_net.to_rbgs.", "inr_net.to_rgbs."): v
          for k, v in load_torch_checkpoint(path).items()}
    heads = [k for k in sd if k.startswith("inr_net.to_rgbs.") and k.endswith(".linear.weight")]
    out_dim = sd[heads[0]].shape[0] if heads else 3
    for k in [k for k in sd if k.startswith("inr_net.network.") and k.endswith("mod1.weight")]:
        res, hidden = k.split(".")[2], sd[k].shape[2]
        for m in ("mod1", "mod2"):
            w = sd[f"inr_net.network.{res}.{m}.weight"]
            sd.setdefault(f"inr_net.network.{res}.{m}.norm.weight", np.ones(w.shape[1], w.dtype))
            sd.setdefault(f"inr_net.network.{res}.{m}.norm.bias", np.zeros(w.shape[1], w.dtype))
        sd.setdefault(f"inr_net.to_rgbs.{res}.linear.weight", np.zeros((out_dim, hidden),
                                                                         np.float32))
        sd.setdefault(f"inr_net.to_rgbs.{res}.linear.bias", np.zeros(out_dim, np.float32))
    gen = GeneratorNerfINR(cfg or GeneratorConfig())
    own = gen.state_dict()
    missing, unexpected = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"{path} does not fit GeneratorNerfINR({cfg or GeneratorConfig()}): "
                       f"missing {missing}, unexpected {unexpected}")
    gen.load_state_dict(to_torch(sd), strict=True)
    return gen.to(device).eval()
