"""Cell builders: (arch x shape) -> a step on the ``meta`` device and the
layout of its inputs (the counterpart of ``repro/launch/specs.py``).

:func:`build_cell` returns everything the dry run needs without one byte
of device memory: the model is built on ``torch.device("meta")`` (shapes
and types only), ``fn()`` runs the port's own ``make_train_step``,
``prefill`` or ``decode_step`` on it, and ``inputs`` pairs every input
tensor with its logical names (:class:`repro_torch.launch.op_cost.Input`),
which :mod:`repro_torch.sharding` resolves per mesh.  A cell may be built
at a cut depth (``n_layers``) for the dry run's per-period count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.launch.op_cost import Input
from repro_torch.models import build_model
from repro_torch.models.layers import dtype_of
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)

META = torch.device("meta")


class Cell(NamedTuple):
    fn: Any                   # fn() runs the step once
    inputs: list              # [(tensor, Input)]
    extra_args: list          # [(shape, dtype, Input)] not held as tensors
    meta: dict
    batch_rows: tuple         # leading sizes of batch-laid new tensors
    microbatches: int         # 0 for a serving step
    train_gathers: int


def train_config_for(arch: ArchSpec, cfg=None) -> tuple[Any, TrainConfig]:
    """The optimizer and parameter type of the train cell: above 150 B
    parameters Adafactor with float32 parameters (Adam's state would not
    fit), otherwise AdamW with a float32 master over bf16 parameters.
    ``cfg`` overrides ``arch.full`` (a cut depth); the rule reads the full
    config's count."""
    full = arch.full
    cfg = full if cfg is None else cfg
    if full.param_count() > 150e9:
        cfg = dataclasses.replace(cfg, param_dtype="float32")
        ocfg = opt_mod.OptimizerConfig(name="adafactor")
    else:
        ocfg = opt_mod.OptimizerConfig(name="adamw", master_fp32=True,
                                       moment_dtype="float32")
    return cfg, TrainConfig(optimizer=ocfg)


def batch_specs(cfg, cell: ShapeCell) -> dict:
    """(shape, dtype) of each batch leaf of the cell."""
    b, s = cell.global_batch, cell.seq_len
    out = {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
    if cfg.input_mode == "embeddings":
        out["embeds"] = ((b, s, cfg.d_model), torch.bfloat16)
    return out


def input_specs(arch: ArchSpec, cell: ShapeCell) -> dict:
    """(shape, dtype) stand-ins for every model input of the cell (a
    decode cell's caches as the model's per-layer list)."""
    cfg = arch.full
    if cell.step == "train":
        cfg, _ = train_config_for(arch)
        return batch_specs(cfg, cell)
    if cell.step == "prefill":
        return batch_specs(cfg, cell)
    model = build_model(cfg, META)
    caches = model.init_caches(cell.global_batch, cell.seq_len)

    def shapes(tree):
        if isinstance(tree, torch.Tensor):
            return (tuple(tree.shape), tree.dtype)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return [shapes(v) for v in tree]
    return {"tokens": ((cell.global_batch, 1), torch.int32),
            "caches": shapes(caches), "position": ((), torch.int32)}


def _cut(cfg, n_layers: int | None):
    if n_layers is None:
        return cfg
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   n_enc_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers)


def _meta_batch(cfg, cell: ShapeCell, names) -> dict:
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, cell).items():
        if name in names:
            out[name] = torch.empty(shape, dtype=dtype, device=META)
    return out


def _batch_inputs(batch: dict) -> list:
    return [(t, Input(("act_batch",) + (None,) * (t.ndim - 1),
                      tuple(t.shape), False, "train", "batch"))
            for t in batch.values()]


def param_inputs(model, profile: str) -> list:
    """Every parameter of ``model`` with its logical names (a layer row of
    a stacked leaf resolved on the stacked shape)."""
    from repro_torch.models.convert import group_params
    from repro_torch.training.optimizer import members, stacked_shape
    specs = model.param_specs()
    out = []
    for path, leaf in group_params(model).items():
        row = isinstance(leaf, list)
        desc = Input(specs[path], stacked_shape(leaf), row, profile, "param")
        out += [(p, desc) for p in members(leaf)]
    return out


def cache_inputs(model, caches, profile: str = "serve") -> list:
    """Every cache tensor (the per-layer list, or an encoder-decoder's
    ``{"self", "cross"}``) with its logical names."""
    specs = model.cache_specs(0)
    parts = (caches.items() if isinstance(caches, dict)
             else [("", caches)])
    out = []
    for part, layer_caches in parts:
        for i, cache in enumerate(layer_caches):
            prefix, row = model.layer_cache_paths(i)
            for name, t in cache.items():
                key = (f"{part}/" if part else "") + prefix
                path = next(p for p in (f"{key}{name}",
                                        f"{key}attn/{name}",
                                        f"{key}mamba/{name}") if p in specs)
                shape = ((1,) + tuple(t.shape) if row is not None
                         else tuple(t.shape))
                out.append((t, Input(specs[path], shape, row is not None,
                                     profile, "cache")))
    return out


def _meta(cfg, cell: ShapeCell, mode: str, **extra) -> dict:
    tokens = cell.global_batch * (cell.seq_len if mode != "decode" else 1)
    return {"mode": mode, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "tokens": tokens,
            "compute_dtype": cfg.compute_dtype, **extra}


def build_train_cell(arch: ArchSpec, cell: ShapeCell,
                     n_layers: int | None = None,
                     tcfg: TrainConfig | None = None) -> Cell:
    cfg, base_tcfg = train_config_for(arch, _cut(arch.full, n_layers))
    tcfg = tcfg or base_tcfg
    model = build_model(cfg, META)
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    names = {"tokens", "labels", "embeds"}
    batch = _meta_batch(cfg, cell, names)
    specs = model.param_specs()
    opt_specs = opt_mod.state_specs(tcfg.optimizer, state.params, specs)
    inputs = param_inputs(model, "train")
    for path, st in state.opt.inner.items():
        for name, t in st.items():
            inputs.append((t, Input(opt_specs.inner[path][name],
                                    tuple(t.shape), False, "train",
                                    "state")))
    inputs.append((state.opt.step, Input((), (), False, "train", "state")))
    inputs += _batch_inputs(batch)
    b, s = cell.global_batch, cell.seq_len
    return Cell(
        fn=lambda: step(state, batch), inputs=inputs, extra_args=[],
        meta=_meta(arch.full if n_layers is None else cfg, cell, "train",
                   optimizer=tcfg.optimizer.name),
        batch_rows=(b // tcfg.accum_steps, b, b * s),
        microbatches=tcfg.accum_steps, train_gathers=2)


def build_prefill_cell(arch: ArchSpec, cell: ShapeCell,
                       profile: str = "serve",
                       n_layers: int | None = None) -> Cell:
    cfg = _cut(arch.full, n_layers)
    model = build_model(cfg, META)
    if cfg.is_encoder_decoder:
        batch = _meta_batch(cfg, cell, {"tokens", "embeds"})
        batch.setdefault("embeds", torch.empty(
            (cell.global_batch, cell.seq_len, cfg.d_model),
            dtype=dtype_of(cfg, "compute"), device=META))

        def fn():
            return model.prefill(batch["embeds"], batch["tokens"])
    else:
        batch = _meta_batch(cfg, cell, {"tokens"})

        def fn():
            return model.prefill(batch["tokens"])
    b, s = cell.global_batch, cell.seq_len
    return Cell(fn=fn, inputs=param_inputs(model, profile)
                + _batch_inputs(batch), extra_args=[],
                meta=_meta(cfg, cell, "prefill"), batch_rows=(b, b * s),
                microbatches=0, train_gathers=0)


def build_decode_cell(arch: ArchSpec, cell: ShapeCell,
                      profile: str = "serve",
                      n_layers: int | None = None) -> Cell:
    cfg = _cut(arch.full, n_layers)
    model = build_model(cfg, META)
    b, s = cell.global_batch, cell.seq_len
    caches = model.init_caches(b, s)
    tokens = torch.empty((b, 1), dtype=torch.int32, device=META)
    position = s - 1
    inputs = (param_inputs(model, profile) + _batch_inputs({"t": tokens})
              + cache_inputs(model, caches))
    pos = ((), torch.int32, Input((), (), False, "serve", "state"))
    return Cell(fn=lambda: model.decode_step(tokens, caches, position),
                inputs=inputs, extra_args=[pos],
                meta=_meta(cfg, cell, "decode"), batch_rows=(b,),
                microbatches=0, train_gathers=0)


def build_cell(arch: ArchSpec, cell: ShapeCell, profile: str = "serve",
               n_layers: int | None = None) -> Cell:
    """The cell's step at ``n_layers`` (the arch's depth for None);
    ``profile`` lays a serving cell's parameters."""
    if cell.step == "train":
        return build_train_cell(arch, cell, n_layers)
    if cell.step == "prefill":
        return build_prefill_cell(arch, cell, profile, n_layers)
    return build_decode_cell(arch, cell, profile, n_layers)


def arguments(c: Cell) -> list:
    """(shape, dtype, Input) of every argument of a cell."""
    return [(tuple(t.shape), t.dtype, d) for t, d in c.inputs] + list(
        c.extra_args)
