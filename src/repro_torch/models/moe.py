"""Mixture-of-Experts: top-k routing with capacity-based index dispatch (the
port of ``repro/models/moe.py``).

Flow (token-major priority, drop-on-overflow, Switch/GShard semantics):
  1. router logits -> softmax -> top-k experts + renormalized gates;
  2. position-in-expert via a cumulative count over the (token, k) pairs;
  3. pairs at a position >= capacity are dropped;
  4. the kept pairs are packed by expert into N x K rows (expert e's group
     ends at ``offs[e]``, the cumulative kept counts), the expert FFN runs
     as three grouped products over those rows
     (``torch.nn.functional.grouped_mm``), and each token sums its kept
     pairs' gated outputs.

Every routed token counts toward the capacity: a serving engine's right-pad
tokens at prefill and its idle lanes at decode too, as in the reference.
Pads come after every real token in token-major order, so they never
displace one.  A ``Moe`` counts, in a plain host integer, the rows its
expert GEMMs ran (``rows``, N x K a dispatch, E x N a dense call); the
spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(:func:`repro_torch.tracing.span`) mark the four steps while a profiler
records.

Where the reference leans on XLA semantics the port spells them out:
  * ``jax.lax.top_k`` puts the lower expert first on equal probabilities
    (bf16 router logits tie often); ``torch.topk`` promises no order, so
    the top k come from a stable descending sort.
  * The reference gathers tokens into (E, C, D) capacity buffers and runs
    every row, C = N in a dropless config, so three quarters of a top-2 of
    8 config's rows are zeros.  Here only the kept pairs' rows run: the
    products give the same values for them, and the empty rows are never
    made.  The packed rows past ``offs[-1]`` (the dropped pairs' share) are
    left undefined by ``grouped_mm``; nothing reads them.
  * The reference's scatter ``mode="drop"`` sends dropped pairs out of
    bounds; here they go to a dummy row ``N*K`` that is sliced off, and in
    the combine to a zero row, so a dropped pair adds exactly zero.
  * The reference's combine is a scatter-add in no set order; here each
    token gathers its k gated pairs (each rounded to x's type) and sums
    them in float32, cast once to x's type, with no float atomics, so two
    launches give the same bits.  For k <= 2 that is the reference's
    result to the bit (a sum of two values of x's type is exact in float32
    and rounded once, as x's type's own addition rounds it); at Granite's
    k = 10 a sum in x's type would round nine times, the float32 sum once.

The expert FFN is XLA in the reference, outside any Pallas kernel; here it
is PyTorch's grouped GEMM over the packed rows (the dense switch keeps a
batched matmul over every expert).  The reference's ``REPRO_MOE_PIN``
pins its (E, C, D) buffers' layout; the packed rows have no expert axis
to pin, so the port has no such switch.
"""
from __future__ import annotations

import functools
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.tracing import span

# Decode-sized batches can skip dispatch entirely (dense mode).  Off by
# default, as in the reference; ``REPRO_MOE_DENSE_MAX=512`` turns it on for
# up to 512 tokens.
DENSE_MODE_MAX_TOKENS = int(os.environ.get("REPRO_MOE_DENSE_MAX", "0"))


def moe_specs(cfg: ModelConfig) -> dict:
    p = {
        "router": ("embed", None),
        "wi": ("experts", "embed", "mlp"),
        "wg": ("experts", "embed", "mlp"),
        "wo": ("experts", "mlp", "embed"),
    }
    if cfg.shared_expert:
        p["shared"] = layers.mlp_specs()
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert: k * N * capacity_factor / E, at least 8, rounded up
    to a multiple of 8."""
    c = int(math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row and their indices, the lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """Switch load-balancing loss E * sum_e f_e P_e (float32)."""
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_idx, n_experts).float().sum(dim=1).mean(dim=0)
    return n_experts * torch.sum(me * ce)


class Moe(nn.Module):
    """Parameters as the reference's leaves: ``router`` (D, E), ``wi``/``wg``
    (E, D, F), ``wo`` (E, F, D) and, with ``cfg.shared_expert``, a gated
    MLP ``shared`` of width ``cfg.shared_d_ff`` (F where that is 0), added
    to every token."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = layers.dtype_of(cfg)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = layers.parameter((d, e), dtype, device)
        self.wi = layers.parameter((e, d, f), dtype, device)
        self.wg = layers.parameter((e, d, f), dtype, device)
        self.wo = layers.parameter((e, f, d), dtype, device)
        if cfg.shared_expert:
            self.shared = layers.Mlp(d, cfg.shared_d_ff or f, dtype, device)
        self.rows = 0

    def init_weights(self, gen: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        for w, std in ((self.router, d), (self.wi, d), (self.wg, d),
                       (self.wo, f)):
            layers.fill_normal(w, 1.0 / math.sqrt(std), gen)
        if self.cfg.shared_expert:
            self.shared.init_weights(gen)

    def route(self, xf: torch.Tensor):
        """xf (N, D) -> (probs (N, E) f32, gates (N, K) f32, expert_idx
        (N, K)): router logits in xf's type, softmax in float32, top k
        renormalized."""
        with span("moe.route"):
            logits = (xf @ self.router.to(xf.dtype)).float()
            probs = torch.softmax(logits, dim=-1)
            gates, expert_idx = top_k(probs, self.cfg.top_k)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return probs, gates, expert_idx

    def _ffn(self, xd: torch.Tensor,
             offs: torch.Tensor | None = None) -> torch.Tensor:
        """The experts' gated MLP: on (E, R, D) buffers, one batched matmul
        a weight; given ``offs``, on (R, D) rows packed by expert (group e
        ends at ``offs[e]``), one grouped product a weight."""
        if offs is None:
            self.rows += xd.shape[0] * xd.shape[1]
            mm = torch.bmm
        else:
            self.rows += xd.shape[0]
            mm = functools.partial(F.grouped_mm, offs=offs)
        with span("moe.experts"):
            h = mm(xd, self.wi.to(xd.dtype))
            g = layers.gate_act(mm(xd, self.wg.to(xd.dtype)),
                                self.cfg.mlp_act)
            return mm(h * g, self.wo.to(xd.dtype))

    def dense(self, xf: torch.Tensor, gates: torch.Tensor,
              expert_idx: torch.Tensor) -> torch.Tensor:
        """Every expert on every token, weighted by the top-k gates: no
        dispatch (the reference's ``_dense_moe``)."""
        w = torch.zeros((xf.shape[0], self.cfg.n_experts),
                        dtype=torch.float32, device=xf.device)
        w.scatter_add_(1, expert_idx, gates)
        y = self._ffn(xf.unsqueeze(0).expand(self.cfg.n_experts, -1, -1))
        return torch.einsum("end,ne->nd", y, w.to(y.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) -> y (B, S, D) in x's type.  The serving path drops
        the load-balancing loss, so it is not computed here (see
        :meth:`apply`)."""
        _, gates, expert_idx = self.route(x.reshape(-1, x.shape[-1]))
        return self._experts(x, gates, expert_idx)

    def apply(self, x):
        """The training path, the reference's ``apply_moe``: x (B, S, D) ->
        (y, the float32 load-balancing loss), differentiable.  Given a
        function instead of a tensor it is ``nn.Module.apply`` (which a
        parent module's ``apply`` calls on its children)."""
        if callable(x):
            return super().apply(x)
        probs, gates, expert_idx = self.route(x.reshape(-1, x.shape[-1]))
        return (self._experts(x, gates, expert_idx),
                aux_loss(probs, expert_idx, self.cfg.n_experts))

    def _experts(self, x: torch.Tensor, gates: torch.Tensor,
                 expert_idx: torch.Tensor) -> torch.Tensor:
        """The routed experts' gated sum (dense or by dispatch) plus the
        shared expert."""
        cfg = self.cfg
        b, s, d = x.shape
        xf = x.reshape(-1, d)
        if xf.shape[0] <= DENSE_MODE_MAX_TOKENS:
            y = self.dense(xf, gates, expert_idx).reshape(b, s, d)
        else:
            y = self.dispatch(xf, gates, expert_idx).reshape(b, s, d)
        if cfg.shared_expert:
            y = y + self.shared(x, cfg.mlp_act)
        return y

    def dispatch(self, xf: torch.Tensor, gates: torch.Tensor,
                 expert_idx: torch.Tensor) -> torch.Tensor:
        """The capacity path: (N, D) tokens -> (N, D) gated expert outputs,
        dropped pairs contributing zero.  The pairs :meth:`slots` keeps are
        packed by expert into N*K rows; nothing waits for the counts on the
        host."""
        k = self.cfg.top_k
        n, d = xf.shape
        c = capacity(n, self.cfg)
        with span("moe.dispatch"):
            e_flat, pos, count = self._positions(expert_idx)
            kept = torch.clamp(count, max=c)
            offs = torch.cumsum(kept, 0, dtype=torch.int32)
            # a kept pair's row is its expert's start plus its position; the
            # dummy row n*k takes every dropped pair and is sliced off
            row = torch.where(pos < c, (offs - kept)[e_flat] + pos, n * k)
            pack_tok = torch.full((n * k + 1,), n, dtype=torch.long,
                                  device=xf.device)
            pack_tok[row] = torch.arange(n * k, device=xf.device) // k
            # the rows past offs[-1] read the zero row n of x_pad, so their
            # undefined gradients land on it and are dropped
            x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
            xp = x_pad[pack_tok[:n * k]]
        yp = self._ffn(xp, offs)
        with span("moe.combine"):
            # a dropped pair selects the zero row n*k, never a row past
            # offs[-1], whose values grouped_mm leaves undefined
            yp = torch.cat([yp, yp.new_zeros((1, d))], dim=0)
            pairs = yp[row].reshape(n, k, d) * gates.to(yp.dtype)[..., None]
            y = pairs.sum(dim=1, dtype=torch.float32).to(xf.dtype)
        return y

    def _positions(self, expert_idx: torch.Tensor):
        """Each (token, k) pair's expert and its position among the
        expert's pairs, counted in token-major order, and each expert's
        count of pairs."""
        e = self.cfg.n_experts
        e_flat = expert_idx.reshape(-1)
        # (E, N*K), so the running count is a scan along contiguous rows
        onehot = (e_flat == torch.arange(e, device=e_flat.device)[:, None])
        run = torch.cumsum(onehot, dim=1)
        pos = (run - 1).gather(0, e_flat[None])[0]
        return e_flat, pos, run[:, -1]

    def slots(self, expert_idx: torch.Tensor, c: int) -> torch.Tensor:
        """Each (token, k) pair's buffer slot ``expert * c + position``,
        positions counted in token-major order; ``E * c`` (dropped) where
        the position reaches ``c``."""
        e_flat, pos, _ = self._positions(expert_idx)
        return torch.where(pos < c, e_flat * c + pos, self.cfg.n_experts * c)
