"""Optimizers, hand-rolled as plain tensor functions (the port of
``repro/training/optimizer.py``; no ``torch.optim``).

* **AdamW** — moments in ``moment_dtype``, decoupled weight decay on every
  leaf, an optional float32 master copy when the parameters are bf16.
* **Adafactor** — factored second moment, no momentum, the update's RMS
  clipped to 1.

Also here: global-norm clipping and the warmup-cosine schedule.  Every
update computes in float32 with the reference's casts; the step is an
int32 tensor and the bias corrections and learning rate are float32
functions of it, so nothing waits for the host.

**The leaves are the reference's.**  The reference keeps each layer kind's
parameters stacked over the layers (``stack/pos{p}/...``); the port keeps
one tensor per layer.  Parameters, gradients and optimizer state here are
dicts in the reference's leaf layout (:func:`repro_torch.models.convert.
group_params`): path -> a tensor (an unstacked leaf) or the list of the
layers' tensors (a stacked leaf), and the state of a leaf is stacked as
the reference's (rows viewed per layer).  What the reference reduces over
a whole leaf is reduced over the whole stack here too: Adafactor's
factoring test on the stacked shape (a stacked norm scale ``(L, d)`` is
factored once ``L >= factored_min_dim``, and its column statistics then
average across the layers), its update-RMS clip, and the global norm.

The state is updated in place and the parameters are written in place
(under ``torch.no_grad()``); the functions return the new state all the
same, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

Leaves = dict          # path -> torch.Tensor | list[torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # bf16 halves Adam state bytes
    master_fp32: bool = False         # keep f32 master when params are bf16
    # adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    inner: dict               # path -> {name: stacked state tensor}


def members(leaf) -> list[torch.Tensor]:
    """A leaf's layer rows (one tensor for an unstacked leaf)."""
    return leaf if isinstance(leaf, list) else [leaf]


def stacked_shape(leaf) -> tuple[int, ...]:
    """The shape the reference's leaf has: (L,) + the row's shape for a
    stacked leaf."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _rows(state: torch.Tensor, leaf) -> list[torch.Tensor]:
    """A stacked state tensor's per-layer views (itself when unstacked)."""
    return list(state.unbind(0)) if isinstance(leaf, list) else [state]


def _stack(leaf) -> torch.Tensor:
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def schedule(cfg: OptimizerConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_ratio * peak (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads: Leaves) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float()))
          for leaf in grads.values() for g in members(leaf)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Leaves, max_norm: float
                        ) -> tuple[Leaves, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)

    def clip(g):
        return (g.float() * scale).to(g.dtype)
    return ({k: [clip(g) for g in v] if isinstance(v, list) else clip(v)
             for k, v in grads.items()}, norm)


def _zero_step(params: Leaves) -> torch.Tensor:
    dev = members(next(iter(params.values())))[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(cfg: OptimizerConfig, params: Leaves) -> OptState:
    mdt = _DTYPES[cfg.moment_dtype]
    inner = {}
    for path, leaf in params.items():
        p = members(leaf)[0]
        shape = stacked_shape(leaf)
        st = {"m": torch.zeros(shape, dtype=mdt, device=p.device),
              "v": torch.zeros(shape, dtype=mdt, device=p.device)}
        if cfg.master_fp32 and p.dtype != torch.float32:
            st["master"] = _stack([x.detach() for x in leaf]
                                  if isinstance(leaf, list)
                                  else leaf.detach()).float()
        inner[path] = st
    return OptState(_zero_step(params), inner)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Leaves, state: OptState,
                 params: Leaves) -> tuple[Leaves, OptState]:
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)
    for path, leaf in params.items():
        st = state.inner[path]
        rows = {k: _rows(v, leaf) for k, v in st.items()}
        for i, (p, g) in enumerate(zip(members(leaf),
                                       members(grads[path]))):
            g32 = g.float()
            m_st, v_st = rows["m"][i], rows["v"][i]
            m = b1 * m_st.float() + (1 - b1) * g32
            v = b2 * v_st.float() + (1 - b2) * g32 * g32
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            base = rows["master"][i] if "master" in rows else p.float()
            new = base - lr * (update + cfg.weight_decay * base)
            m_st.copy_(m)
            v_st.copy_(v)
            if "master" in rows:
                rows["master"][i].copy_(new)
            p.copy_(new)
    return params, OptState(step, state.inner)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern, 2018): factored v, no momentum
# ---------------------------------------------------------------------------
def _factored(cfg: OptimizerConfig, shape: tuple[int, ...]) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= cfg.factored_min_dim


def adafactor_init(cfg: OptimizerConfig, params: Leaves) -> OptState:
    inner = {}
    for path, leaf in params.items():
        shape, dev = stacked_shape(leaf), members(leaf)[0].device
        if _factored(cfg, shape):
            inner[path] = {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=dev),
                "vc": torch.zeros(shape[:-2] + shape[-1:],
                                  dtype=torch.float32, device=dev)}
        else:
            inner[path] = {"v": torch.zeros(shape, dtype=torch.float32,
                                            device=dev)}
    return OptState(_zero_step(params), inner)


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads: Leaves, state: OptState,
                     params: Leaves) -> tuple[Leaves, OptState]:
    """Each leaf updates as one stacked tensor, as the reference's does
    (its column statistics and update RMS span the layers)."""
    step = state.step + 1
    lr = schedule(cfg, step)
    t = step.float()
    beta2 = 1.0 - t ** (-cfg.decay_rate)
    for path, leaf in params.items():
        st = state.inner[path]
        g32 = _stack(grads[path]).float()
        g2 = g32 * g32 + 1e-30
        if "vr" in st:
            vr = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.sqrt(
                vr[..., :, None] * vc[..., None, :]
                / torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None],
                              min=1e-30))
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            denom = torch.sqrt(v)
            st["v"].copy_(v)
        update = g32 / torch.clamp(denom, min=cfg.eps)
        # update clipping (RMS <= 1), per Adafactor, over the whole leaf
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        base = _stack([x.detach() for x in leaf] if isinstance(leaf, list)
                      else leaf).float()
        new = base - lr * (update + cfg.weight_decay * base)
        for p, row in zip(members(leaf), _rows(new, leaf)):
            p.copy_(row)
    return params, OptState(step, state.inner)


# ---------------------------------------------------------------------------
# Logical-axis specs for the optimizer state (mirrors init's structure)
# ---------------------------------------------------------------------------
def state_specs(cfg: OptimizerConfig, params: Leaves,
                param_specs: dict) -> OptState:
    """The logical axis names of :func:`init`'s state: each state tensor
    inherits its parameter's names (``param_specs``, as
    ``model.param_specs()`` gives them), factored Adafactor statistics the
    surviving dimensions'; the step is a replicated scalar, ``()``."""
    inner = {}
    for path, leaf in params.items():
        spec = tuple(param_specs[path])
        if cfg.name == "adafactor":
            inner[path] = ({"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
                           if _factored(cfg, stacked_shape(leaf))
                           else {"v": spec})
            continue
        st = {"m": spec, "v": spec}
        if cfg.master_fp32 and members(leaf)[0].dtype != torch.float32:
            st["master"] = spec
        inner[path] = st
    return OptState(step=(), inner=inner)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------
def init(cfg: OptimizerConfig, params: Leaves) -> OptState:
    if cfg.name == "adafactor":
        return adafactor_init(cfg, params)
    return adamw_init(cfg, params)


def update(cfg: OptimizerConfig, grads: Leaves, state: OptState,
           params: Leaves) -> tuple[Leaves, OptState, torch.Tensor]:
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    if cfg.name == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params)
    else:
        new_p, new_s = adamw_update(cfg, grads, state, params)
    return new_p, new_s, gnorm
