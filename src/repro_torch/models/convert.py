"""Carry weights and caches across from the reference's trees.

The reference keeps its parameters in a nested dict whose ``stack`` groups
the layers by their place in the repeating kind pattern (``pos{p}``, each
leaf stacked over the repeats), and its caches as ``{"main": {pos: stacked},
"tail": {pos: single}}``.  :func:`params_from_numpy` unstacks such a tree
(``jax.tree.map(np.asarray, params)``) into this port's ``state_dict``
(``layers.{i}.attn.wq`` and so on) and :func:`caches_from_numpy` the cache
tree (attention ``{"k", "v"}`` and Mamba ``{"conv_x", "conv_b", "conv_c",
"ssm"}`` leaves alike) into the port's per-layer list, so both packages
compute on the same numbers.  bfloat16 leaves (numpy's ``ml_dtypes``
type) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DecoderOnlyLM


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
    period = cfg.period()
    sd = {f"embed.{k}": tensor_from_numpy(v, device)
          for k, v in _flatten(tree["embed"]).items()}
    sd["final_norm.scale"] = tensor_from_numpy(tree["final_norm"]["scale"],
                                               device)
    for i in range(cfg.n_layers):
        # position i % period holds layers i % period, + period, ... stacked
        stacked = _flatten(tree["stack"][f"pos{i % period}"])
        for k, v in stacked.items():
            sd[f"layers.{i}.{k}"] = tensor_from_numpy(
                np.asarray(v)[i // period], device)
    return sd


def caches_from_numpy(cfg: ModelConfig, tree: dict,
                      device: torch.device | str = "cpu") -> list:
    """The reference's cache tree (numpy leaves) as the port's per-layer
    list of cache dicts (``{"k", "v"}`` or the Mamba state) on ``device``."""
    out = []
    for i in range(cfg.n_layers):
        part, pos, rep = _layer_slot(cfg, i)
        (leaves,) = tree[part][pos].values()   # {"attn"|"mamba": {...}}
        out.append({name: tensor_from_numpy(
            np.asarray(v) if rep is None else np.asarray(v)[rep], device)
            for name, v in leaves.items()})
    return out


def model_from_state_dict(cfg: ModelConfig, state_dict: dict,
                          device: torch.device | str = "cuda"
                          ) -> DecoderOnlyLM:
    """A model whose parameters *are* the tensors of ``state_dict`` (moved
    to ``device`` if they live elsewhere): no copy on the device, so models
    built from one state dict share their weights."""
    dev = resolve_device(device)
    model = DecoderOnlyLM(cfg, "meta")
    model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()},
                          assign=True)
    return model
