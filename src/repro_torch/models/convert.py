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


# ---------------------------------------------------------------------------
# The reference's leaves, grouped from the port's per-layer parameters
# ---------------------------------------------------------------------------
def ref_leaf(cfg: ModelConfig, name: str) -> tuple[str, int | None]:
    """The reference leaf that holds the port parameter ``name``, as a path
    (``"stack/pos0/attn/wq"``), and its row in that leaf's layer stack (None
    for an unstacked leaf such as ``embed/table``)."""
    head, *rest = name.split(".")
    if head not in ("layers", "encoder", "decoder"):
        return "/".join([head, *rest]), None
    i, rest = int(rest[0]), rest[1:]
    period = 1 if head == "encoder" else cfg.period()
    stack = "stack" if head == "layers" else head
    return "/".join([stack, f"pos{i % period}", *rest]), i // period


def group_params(model: torch.nn.Module) -> dict:
    """The model's parameters laid out as the reference's leaves: path ->
    the parameter itself (an unstacked leaf) or the list of the layers'
    parameters in stack order (a stacked leaf), paths in the order of
    ``jax.tree_util``'s flatten (sorted keys at every level).  The
    tensors *are* the model's parameters."""
    rows: dict[str, dict[int | None, torch.Tensor]] = {}
    for name, p in model.named_parameters():
        path, row = ref_leaf(model.cfg, name)
        rows.setdefault(path, {})[row] = p
    out = {}
    for path in sorted(rows, key=lambda x: x.split("/")):
        members = rows[path]
        out[path] = (members[None] if None in members else
                     [members[i] for i in range(len(members))])
    return out


def _subtree(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, last = path.split("/")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = v
    return out


def _leaf_numpy(t) -> np.ndarray:
    """A leaf (a tensor or a list of layer rows, stacked) as numpy;
    bfloat16 widened to float32."""
    if isinstance(t, list):
        t = torch.stack([x.detach() for x in t])
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(model: torch.nn.Module) -> dict:
    """The inverse of :func:`params_from_numpy`: the model's parameters as
    the reference's LM parameter tree of numpy leaves (layers stacked;
    bfloat16 widened to float32)."""
    return _nest({path: _leaf_numpy(leaf)
                  for path, leaf in group_params(model).items()})


def train_state_from_numpy(cfg: ModelConfig, tcfg, ref_state,
                           device: torch.device | str = "cpu"):
    """A reference ``TrainState`` (numpy leaves: ``jax.tree.map(np.asarray,
    state)``) as the port's: the model whose parameters are its weights,
    and a :class:`repro_torch.training.TrainState` over them carrying the
    reference's step, optimizer state (stacked leaves as the reference
    keeps them) and error-feedback buffers.  Returns (model, state).
    Raises ``ValueError`` when the state does not fit ``tcfg`` (the
    optimizer's state names, the error-feedback buffers)."""
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training.train_step import TrainState, unfreeze
    if (ref_state.ef_residual is None) != (tcfg.compression.mode
                                           != "int8_ef"):
        raise ValueError(f"error-feedback buffers do not fit compression "
                         f"{tcfg.compression.mode!r}")
    dev = resolve_device(device)
    model = model_from_state_dict(
        cfg, params_from_numpy(cfg, ref_state.params, dev), dev)
    params = unfreeze(model)
    ref_opt = ref_state.opt
    inner = {path: {k: tensor_from_numpy(v, dev)
                    for k, v in _subtree(ref_opt.inner, path).items()}
             for path in params}
    names = ({"v"}, {"vr", "vc"}) if tcfg.optimizer.name == "adafactor" \
        else ({"m", "v"}, {"m", "v", "master"})
    bad = [path for path, st in inner.items() if set(st) not in names]
    if bad:
        raise ValueError(f"optimizer state of {bad[:3]} does not fit "
                         f"{tcfg.optimizer.name!r}")
    ef = (None if ref_state.ef_residual is None else
          {path: tensor_from_numpy(_subtree(ref_state.ef_residual, path), dev)
           for path in params})
    step = torch.tensor(int(np.asarray(ref_opt.step)), dtype=torch.int32,
                        device=dev)
    return model, TrainState(params, opt_mod.OptState(step, inner), ef)


def train_state_to_numpy(state) -> dict:
    """The inverse of :func:`train_state_from_numpy` for comparison: the
    port's ``TrainState`` as the reference's tree of numpy leaves, as
    nested dicts (``{"params", "opt": {"step", "inner"}, "ef_residual"}``),
    stacked leaves stacked."""
    inner = state.opt.inner
    return {
        "params": _nest({k: _leaf_numpy(v)
                         for k, v in state.params.items()}),
        "opt": {"step": _leaf_numpy(state.opt.step),
                "inner": _nest({k: {n: _leaf_numpy(t) for n, t in st.items()}
                                for k, st in inner.items()})},
        "ef_residual": (None if state.ef_residual is None else _nest(
            {k: _leaf_numpy(v) for k, v in state.ef_residual.items()}))}


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
