"""JAX parameter trees ↔ the port's `state_dict`s, with numpy only.

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
  * mapping ``base_{i}``/``base_norm_{i}``/``norm_out`` → ``base_net.{slot}``
    (the equalised-lr mapping: ``base_{i}`` → ``base.{i}``, ``head_{n}_{i}``
    → ``heads.{n}.{i}``, `mapping_equal_lr_state_dict`);
  * ``inr_net/block_{res}`` → ``inr_net.network.{res}``, ``to_rgb_{res}`` →
    ``inr_net.to_rgbs.{res}`` (zero placeholders for the heads the JAX
    model never creates), ``out_linear`` → ``inr_net.tanh.0``;
  * ``aux_to_rgb`` → ``aux_to_rbg.0``.

The discriminator's tree (``d_params``) maps onto the port's
`DiscriminatorMultiScaleAux` the same way: ``conv_in_{res}`` →
``conv_in.{res}``, ``res_{res}`` → ``blocks.{res}``, equalized-lr linear
kernels (in, out) → weights (out, in); conv weights are OIHW in both.

The inverse maps (`jax_tree_from_state_dict`, `jax_d_tree_from_state_dict`)
rebuild the JAX trees key for key and drop what the JAX model does not
have (the unused LayerNorms and ToRGB placeholders); `optax_adam_state`
and `load_optax_adam_state` move Adam's moments and count between
`torch.optim.Adam` and optax's ``(ScaleByAdamState(count, mu, nu),
EmptyState())``.  So snapshots move both ways between the packages.

`tree_state_dict` carries any model-zoo module (`models/legacy.py`,
`models/nerf_variants.py`) across: its submodules carry the JAX names, so
``kernel`` (in, out) becomes ``weight`` (out, in), ``scale`` becomes
``weight`` and the names are joined by ``.``.

`inception_state_dict` maps the JAX package's InceptionV3 tree
(``{Conv2d_*: {w, bn_*}, Mixed_*: {branch: {w, bn_*}}}``) onto
torch-fidelity's names, which `eval/inception.py::InceptionV3` carries.
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


def mapping_equal_lr_state_dict(tree: dict) -> Dict[str, np.ndarray]:
    """A `MultiHeadMappingNetworkEqualLR` tree ({"params": {...}} or the
    inner dict) → the port module's state dict: ``base_{i}`` →
    ``base.{i}``, ``head_{name}_{i}`` → ``heads.{name}.{i}``, each
    equalised-lr kernel (in, out) → weight (out, in)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.get("params", tree).items():
        if k.startswith("head_"):
            name, i = k[len("head_"):].rsplit("_", 1)
            _linear(out, v, f"heads.{name}.{i}")
        else:
            _linear(out, v, f"base.{k[len('base_'):]}")
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


def tree_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """A model-zoo module's JAX params ({"params": {...}} or the inner dict)
    → the state dict of its port counterpart: ``kernel`` → ``weight`` (out,
    in), ``scale`` → ``weight``, other leaves as they are, names joined by
    ``.``."""
    sd: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                sd[f"{prefix}weight"] = _np(v).T.copy()
            else:
                sd[prefix + ("weight" if k == "scale" else k)] = _np(v).copy()

    walk(params.get("params", params), "")
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


# ---------------------------------------------------------------- port -> JAX

def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _unlinear(sd: dict, name: str, bias: bool = True) -> dict:
    out = {"kernel": _t(sd[f"{name}.weight"]).T.copy()}
    if bias and f"{name}.bias" in sd:
        out["bias"] = _t(sd[f"{name}.bias"]).copy()
    return out


def _unfilm(sd: dict, name: str) -> dict:
    return {part: _unlinear(sd, f"{name}.{part}") for part in ("linear", "gain_fc", "bias_fc")}


def _sub(sd: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def mapping_tree(sd: dict) -> dict:
    """``base_net.{slot}`` keys → a mapping network's tree (Linear slots
    are ``base_{i}``, a LayerNorm after Linear i is ``base_norm_{i}``, one
    after the last Linear is ``norm_out``)."""
    slots = sorted({int(k.split(".")[1]) for k in sd if k.startswith("base_net.")})
    linear = [s_ for s_ in slots if _t(sd[f"base_net.{s_}.weight"]).ndim == 2]
    out, i = {}, -1
    for slot in slots:
        name = f"base_net.{slot}"
        if slot in linear:
            i += 1
            out[f"base_{i}"] = _unlinear(sd, name)
        else:
            key = "norm_out" if slot > linear[-1] else f"base_norm_{i}"
            out[key] = {"scale": _t(sd[f"{name}.weight"]).copy(),
                        "bias": _t(sd[f"{name}.bias"]).copy()}
    return out


def siren_tree(sd: dict) -> dict:
    out = {}
    films = sorted({int(k.split(".")[1]) for k in sd if k.startswith("network.")})
    for i in films:
        out[f"film_{i}"] = _unfilm(sd, f"network.{i}")
    out["sigma"] = _unlinear(sd, "final_layer")
    out["color_film"] = _unfilm(sd, "color_layer_sine")
    out["color_linear"] = _unlinear(sd, "color_layer_linear.0")
    return out


def inr_tree(sd: dict) -> dict:
    """A `CIPSNet` state dict → its JAX tree: the ToRGB heads from block
    FIRST_RGB on (the others are placeholders), no LayerNorms."""
    from cips3d_tpu_torch.models.cips_net import CIPS_RESOLUTIONS, FIRST_RGB

    out = {}
    for res in sorted({k.split(".")[1] for k in sd if k.startswith("network.")}, key=int):
        out[f"block_{res}"] = {
            m: {"weight": _t(sd[f"network.{res}.{m}.weight"])[0].copy(),
                "modulation": _unlinear(sd, f"network.{res}.{m}.modulation")}
            for m in ("mod1", "mod2")}
    for res in CIPS_RESOLUTIONS[FIRST_RGB:]:
        if f"to_rgbs.{res}.linear.weight" in sd:
            out[f"to_rgb_{res}"] = {"linear": _unlinear(sd, f"to_rgbs.{res}.linear")}
    if "tanh.0.weight" in sd:
        out["out_linear"] = _unlinear(sd, "tanh.0")
    return out


def jax_tree_from_state_dict(sd: dict) -> dict:
    """The port's `GeneratorNerfINR` state dict → the JAX generator's
    params ``{"params": {...}}`` (numpy f32)."""
    return {"params": {
        "siren": siren_tree(_sub(sd, "siren")),
        "mapping_network_nerf": mapping_tree(_sub(sd, "mapping_network_nerf")),
        "mapping_network_inr": mapping_tree(_sub(sd, "mapping_network_inr")),
        "inr_net": inr_tree(_sub(sd, "inr_net")),
        "aux_to_rgb": _unlinear(sd, "aux_to_rbg.0"),
    }}


def jax_d_tree_from_state_dict(sd: dict) -> dict:
    """The port's discriminator state dict → the JAX discriminator's params."""
    out: dict = {}
    for key, v in sd.items():
        parts = key.split(".")
        path, i = [], 0
        while i < len(parts):
            if parts[i] == "conv_in":
                path.append(f"conv_in_{parts[i + 1]}")
                i += 2
            elif parts[i] == "blocks":
                path.append(f"res_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        a = _t(v)
        if path[-1] == "weight" and a.ndim == 2:   # equalized-lr linear: kernel (in, out)
            path[-1], a = "kernel", a.T
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = a.copy()
    return {"params": out}


def optax_adam_state(opt, module, tree_fn) -> dict:
    """`torch.optim.Adam` over ``module``'s parameters → optax's Adam state
    as a nested dict ``{"0": {"count", "mu", "nu"}}`` (the key paths of
    ``(ScaleByAdamState(count, mu, nu), EmptyState())``); ``tree_fn`` maps
    a state dict to the JAX tree (`jax_tree_from_state_dict` for G)."""
    names = dict((id(p), n) for n, p in module.named_parameters())
    mu, nu, count = {}, {}, 0
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            name = names[id(p)]
            mu[name] = st["exp_avg"] if "exp_avg" in st else np.zeros(p.shape, np.float32)
            nu[name] = st["exp_avg_sq"] if "exp_avg_sq" in st else np.zeros(p.shape, np.float32)
            if "step" in st:
                count = max(count, int(st["step"]))
    return {"0": {"count": np.asarray(count, np.int32), "mu": tree_fn(mu), "nu": tree_fn(nu)}}


def load_optax_adam_state(opt, module, state: dict, sd_fn) -> None:
    """optax's Adam state (as `optax_adam_state` returns it, or as read
    from a snapshot's ``g_opt.npz``/``d_opt.npz``) → ``opt``'s per-parameter
    state; ``sd_fn`` maps a JAX tree to a state dict (`state_dict_from_jax`
    for G).  Parameters the JAX model lacks restart at zero moments.  State
    tensors the optimizer already holds are written in place (a captured
    step keeps reading them); new ones follow the optimizer's placement (a
    capturable Adam's step count on the device)."""
    import torch

    st = state["0"]
    count = int(np.asarray(st["count"]))
    mu, nu = sd_fn(st["mu"]), sd_fn(st["nu"])
    capturable = any(g.get("capturable", False) for g in opt.param_groups)
    if count == 0 and not any(opt.state.values()):
        return
    for name, p in module.named_parameters():
        moments = [torch.from_numpy(np.asarray(src[name], np.float32))
                   if name in src and count else torch.zeros_like(p, device="cpu")
                   for src in (mu, nu)]
        cur = opt.state.get(p)
        if cur:   # into the tensors the optimizer (and a captured step) already holds
            cur["step"].fill_(float(count))
            cur["exp_avg"].copy_(moments[0])
            cur["exp_avg_sq"].copy_(moments[1])
            continue
        # a capturable Adam keeps its step count on the parameter's device
        opt.state[p] = {
            "step": (torch.full((), float(count), device=p.device) if capturable
                     else torch.tensor(float(count))),
            "exp_avg": moments[0].to(p.device).clone(),
            "exp_avg_sq": moments[1].to(p.device).clone(),
        }


# ---------------------------------------------------------------- the variants

def cam_tree_from_state_dict(sd: dict) -> dict:
    """The camera's state dict → its JAX tree ``{"params": {...}}``."""
    return {"params": {k: _t(v).copy() for k, v in sd.items()}}


def cam_state_dict(tree: dict) -> Dict[str, np.ndarray]:
    """A camera's JAX tree → its state dict."""
    return {k: _np(v).copy() for k, v in tree.get("params", tree).items()}


_PIGAN_MAPPING = {"fc0": "0", "fc1": "2", "fc2": "4", "fc_out": "6"}


def pigan_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """JAX `ImplicitGenerator3d` params → the port's state dict."""
    siren = params.get("params", params)["siren"]
    sd: Dict[str, np.ndarray] = {}
    for k, v in siren.items():
        if k.startswith("film_"):
            _linear(sd, v["layer"], f"siren.network.{k[len('film_'):]}.layer")
        elif k == "mapping_network":
            for name, slot in _PIGAN_MAPPING.items():
                _linear(sd, v[name], f"siren.mapping_network.network.{slot}")
    _linear(sd, siren["sigma"], "siren.final_layer")
    _linear(sd, siren["color_film"]["layer"], "siren.color_layer_sine.layer")
    _linear(sd, siren["color_linear"], "siren.color_layer_linear.0")
    return sd


def pigan_tree_from_state_dict(sd: dict) -> dict:
    """The port's `ImplicitGenerator3d` state dict → the JAX params."""
    films = sorted({int(k.split(".")[2]) for k in sd if k.startswith("siren.network.")})
    siren = {f"film_{i}": {"layer": _unlinear(sd, f"siren.network.{i}.layer")} for i in films}
    siren["mapping_network"] = {name: _unlinear(sd, f"siren.mapping_network.network.{slot}")
                                for name, slot in _PIGAN_MAPPING.items()}
    siren["sigma"] = _unlinear(sd, "siren.final_layer")
    siren["color_film"] = {"layer": _unlinear(sd, "siren.color_layer_sine.layer")}
    siren["color_linear"] = _unlinear(sd, "siren.color_layer_linear.0")
    return {"params": {"siren": siren}}


def pigan_d_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """JAX `ProgressiveDiscriminator` params (the blocks it has) → the
    matching part of the port's state dict."""
    sd: Dict[str, np.ndarray] = {}
    for k, v in params.get("params", params).items():
        if k.startswith("block_"):
            i = k[len("block_"):]
            for j, conv in (("0", "conv1"), ("2", "conv2")):
                sd[f"layers.{i}.network.{j}.conv.weight"] = _np(v[conv]["weight"]).copy()
                sd[f"layers.{i}.network.{j}.conv.bias"] = _np(v[conv]["bias"]).copy()
            if "proj_weight" in v:
                sd[f"layers.{i}.proj.weight"] = _np(v["proj_weight"]).copy()
                sd[f"layers.{i}.proj.bias"] = _np(v["proj_bias"]).copy()
        else:
            name = "final_layer" if k == "final" else f"fromRGB.{k[len('from_rgb_'):]}.model.0"
            sd[f"{name}.weight"] = _np(v["kernel"]).transpose(3, 2, 0, 1).copy()   # HWIO → OIHW
            sd[f"{name}.bias"] = _np(v["bias"]).copy()
    return sd


def pigan_d_tree_from_state_dict(sd: dict) -> dict:
    """The port's `ProgressiveDiscriminator` state dict → the JAX params,
    every block and input conv."""
    out: dict = {}
    for key, v in sd.items():
        parts, a = key.split("."), _t(v).copy()
        if parts[0] == "layers":
            blk = out.setdefault(f"block_{parts[1]}", {})
            if parts[2] == "proj":
                blk[f"proj_{parts[3]}"] = a
            else:
                blk.setdefault("conv1" if parts[3] == "0" else "conv2", {})[parts[-1]] = a
        else:
            name = "final" if parts[0] == "final_layer" else f"from_rgb_{parts[1]}"
            out.setdefault(name, {})["kernel" if parts[-1] == "weight" else "bias"] = (
                a.transpose(2, 3, 1, 0).copy() if parts[-1] == "weight" else a)   # OIHW → HWIO
    return {"params": out}


def load_partial(module, sd: Dict[str, np.ndarray]) -> None:
    """Load a state dict that may cover only part of ``module`` (a JAX
    pi-GAN D holds only the blocks of its size); every key must exist and
    match in shape."""
    import torch

    own = module.state_dict()
    extra = [k for k in sd if k not in own or tuple(own[k].shape) != sd[k].shape]
    if extra:
        raise KeyError(f"keys absent from the module or of another shape: {extra[:5]}")
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.from_numpy(np.asarray(v, np.float32)))


# ---------------------------------------------------------------- InceptionV3

_BN = (("w", "conv.weight"), ("bn_g", "bn.weight"), ("bn_b", "bn.bias"),
       ("bn_m", "bn.running_mean"), ("bn_v", "bn.running_var"))


def inception_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """A JAX package InceptionV3 tree (`random_params`,
    `convert_inception_state_dict`: ``{Conv2d_*: conv, Mixed_*: {branch:
    conv}}``, each conv ``{w, bn_g, bn_b, bn_m, bn_v}``) → the port's
    `eval/inception.py::InceptionV3` state dict (torch-fidelity's names)."""
    sd: Dict[str, np.ndarray] = {}

    def conv(prefix, p):
        for src, dst in _BN:
            sd[f"{prefix}.{dst}"] = _np(p[src]).copy()

    for mod, tree in params.items():
        if "w" in tree:
            conv(mod, tree)
        else:
            for branch, p in tree.items():
                conv(f"{mod}.{branch}", p)
    return sd
