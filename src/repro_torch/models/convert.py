"""Carry weights and caches across from the reference's trees.

The reference keeps its parameters in a nested dict whose ``stack`` groups
the layers by their place in the repeating kind pattern (``pos{p}``, each
leaf stacked over the repeats), and its caches as ``{"main": {pos: stacked},
"tail": {pos: single}}``.  :func:`params_from_numpy` unstacks such a tree
(``jax.tree.map(np.asarray, params)``) into this port's ``state_dict``
(``layers.{i}.attn.wq``, ``layers.{i}.moe.wi`` and so on; an
encoder-decoder's two stacks ``encoder`` and ``decoder`` into
``encoder.{i}.*`` and ``decoder.{i}.*``) and :func:`caches_from_numpy` the
cache tree (attention ``{"k", "v"}`` and Mamba ``{"conv_x", "conv_b",
"conv_c", "ssm"}`` leaves alike; an encoder-decoder's ``{"self",
"cross"}``) into the port's per-layer lists, so both packages compute on
the same numbers.  bfloat16 leaves (numpy's ``ml_dtypes``
type) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_class


def tensor_from_numpy(x, device: torch.device | str = "cpu") -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _layer_slot(cfg: ModelConfig, i: int) -> tuple[str, str, int | None]:
    """Where layer i lives in a reference stack tree: ("main", pos, repeat)
    or ("tail", pos, None)."""
    period = cfg.period()
    n_full = cfg.n_layers // period
    if i < n_full * period:
        return "main", f"pos{i % period}", i // period
    return "tail", f"pos{i - n_full * period}", None


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device: torch.device | str = "cpu") -> dict:
    """The reference's LM parameter tree (numpy leaves) as the port's
    ``state_dict``, tensors on ``device``."""
    sd = {f"embed.{k}": tensor_from_numpy(v, device)
          for k, v in _flatten(tree["embed"]).items()}
    for norm in ("final_norm", "enc_norm"):
        if norm in tree:
            sd[f"{norm}.scale"] = tensor_from_numpy(tree[norm]["scale"],
                                                    device)
    # (stack, its layers, its kind pattern's period); an encoder's layers
    # are all of one kind
    stacks = ({"encoder": (tree["encoder"], cfg.n_enc_layers, 1),
               "decoder": (tree["decoder"], cfg.n_layers, cfg.period())}
              if cfg.is_encoder_decoder else
              {"layers": (tree["stack"], cfg.n_layers, cfg.period())})
    for name, (stack, n_layers, period) in stacks.items():
        for i in range(n_layers):
            # position i % period holds layers i % period, + period, ...
            for k, v in _flatten(stack[f"pos{i % period}"]).items():
                sd[f"{name}.{i}.{k}"] = tensor_from_numpy(
                    np.asarray(v)[i // period], device)
    return sd


def caches_from_numpy(cfg: ModelConfig, tree: dict,
                      device: torch.device | str = "cpu") -> list | dict:
    """The reference's cache tree (numpy leaves) as the port's per-layer
    list of cache dicts (``{"k", "v"}`` or the Mamba state) on ``device``;
    an encoder-decoder's as ``{"self": [...], "cross": [...]}``."""
    if cfg.is_encoder_decoder:
        return {part: _cache_list(cfg, tree[part], device)
                for part in ("self", "cross")}
    return _cache_list(cfg, tree, device)


def _cache_list(cfg: ModelConfig, tree: dict, device) -> list:
    out = []
    for i in range(cfg.n_layers):
        part, pos, rep = _layer_slot(cfg, i)
        node = tree[part][pos]
        # {"attn"|"mamba": {...}}, or a cross cache's {"k", "v"} itself
        (leaves,) = [node] if set(node) == {"k", "v"} else node.values()
        out.append({name: tensor_from_numpy(
            np.asarray(v) if rep is None else np.asarray(v)[rep], device)
            for name, v in leaves.items()})
    return out


def model_from_state_dict(cfg: ModelConfig, state_dict: dict,
                          device: torch.device | str = "cuda"
                          ) -> torch.nn.Module:
    """A model whose parameters *are* the tensors of ``state_dict`` (moved
    to ``device`` if they live elsewhere): no copy on the device, so models
    built from one state dict share their weights."""
    dev = resolve_device(device)
    model = model_class(cfg)(cfg, "meta")
    model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()},
                          assign=True)
    return model
