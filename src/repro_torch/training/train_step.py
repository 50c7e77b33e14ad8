"""The train step: loss -> grads -> (accumulate) -> (compress) -> clip ->
update (the port of ``repro/training/train_step.py``).

Gradient accumulation over ``accum_steps`` microbatches (contiguous row
blocks of the batch) is also the activation-memory lever of the large
cells: each microbatch reruns the forward, whose blocks recompute in the
backward pass (``cfg.remat``).  The forward is the models' plain
differentiable ``train_loss``, the path the reference trains through: no
kernel of :mod:`repro_torch.kernels` runs in a step.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.convert import group_params
from repro_torch.training import grad_compression
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import Leaves, members


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt_mod.OptimizerConfig = dataclasses.field(
        default_factory=opt_mod.OptimizerConfig)
    compression: grad_compression.CompressionConfig = dataclasses.field(
        default_factory=grad_compression.CompressionConfig)
    moe_aux_weight: float = 0.01
    accum_steps: int = 1


class TrainState(NamedTuple):
    params: Leaves            # the model's own parameters, by reference leaf
    opt: opt_mod.OptState
    ef_residual: dict | None  # error-feedback buffers (int8_ef) or None


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    aux_loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor


def unfreeze(model: torch.nn.Module) -> Leaves:
    """Make every parameter of ``model`` take gradients (serving keeps them
    frozen) and return them grouped by reference leaf."""
    for p in model.parameters():
        p.requires_grad_(True)
    return group_params(model)


def init_train_state(model: torch.nn.Module, tcfg: TrainConfig
                     ) -> TrainState:
    """A train state over the model's current weights, which it unfreezes;
    zero optimizer state (and error-feedback buffers with ``int8_ef``)."""
    params = unfreeze(model)
    opt = opt_mod.init(tcfg.optimizer, params)
    ef = (grad_compression.init_error_feedback(params)
          if tcfg.compression.mode == "int8_ef" else None)
    return TrainState(params=params, opt=opt, ef_residual=ef)


def _regroup(params: Leaves, flat: list) -> Leaves:
    out, it = {}, iter(flat)
    for path, leaf in params.items():
        rows = [next(it) for _ in members(leaf)]
        out[path] = rows if isinstance(leaf, list) else rows[0]
    return out


def make_train_step(model: torch.nn.Module, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The
    state's parameters are written in place; ``state.params`` must be the
    model's own (as :func:`init_train_state` makes them)."""

    def single_grads(flat: list, batch: dict):
        loss, aux = model.train_loss(batch)
        total = loss + tcfg.moe_aux_weight * aux
        grads = torch.autograd.grad(total, flat, allow_unused=True)
        # a parameter the batch does not reach (the token table of a
        # decoder fed embeddings) has a zero gradient, as in the reference
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return grads, loss.detach(), aux.detach()

    def accum_grads(flat: list, batch: dict):
        """Microbatches are contiguous row blocks; their gradients are
        summed in float32 in order, then scaled by 1/a."""
        a = tcfg.accum_steps
        n = next(iter(batch.values())).shape[0]
        mb = n // a
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
        loss_acc = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        aux_acc = torch.zeros_like(loss_acc)
        for i in range(a):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            grads, loss, aux = single_grads(flat, micro)
            for g_acc, g in zip(acc, grads):
                g_acc.add_(g)
            del grads
            loss_acc = loss_acc + loss
            aux_acc = aux_acc + aux
        scale = 1.0 / a
        for g_acc in acc:
            g_acc.mul_(scale)
        return acc, loss_acc * scale, aux_acc * scale

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, StepMetrics]:
        flat = [p for leaf in state.params.values() for p in members(leaf)]
        if tcfg.accum_steps > 1:
            flat_g, loss, aux = accum_grads(flat, batch)
        else:
            flat_g, loss, aux = single_grads(flat, batch)
        grads = _regroup(state.params, flat_g)
        del flat_g

        ef = state.ef_residual
        if tcfg.compression.mode == "int8_ef":
            grads, ef = grad_compression.compress_int8_ef(grads, ef)
        else:
            grads = grad_compression.compress_cast(grads, tcfg.compression)

        new_params, new_opt, gnorm = opt_mod.update(
            tcfg.optimizer, grads, state.opt, state.params)
        metrics = StepMetrics(
            loss=loss, aux_loss=aux, grad_norm=gnorm,
            lr=opt_mod.schedule(tcfg.optimizer, new_opt.step))
        return TrainState(new_params, new_opt, ef), metrics

    return train_step
