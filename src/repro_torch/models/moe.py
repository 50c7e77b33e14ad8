"""Mixture-of-Experts: top-k routing with capacity-based index dispatch (the
port of ``repro/models/moe.py``).

Flow (token-major priority, drop-on-overflow, Switch/GShard semantics):
  1. router logits -> softmax -> top-k experts + renormalized gates;
  2. position-in-expert via a cumulative count over the (token, k) pairs;
  3. pairs at a position >= capacity are dropped;
  4. tokens are gathered into (E, C, D) buffers, the expert FFN runs as one
     batched matmul, and each token sums its kept pairs' gated outputs.

Every routed token counts toward the capacity: a serving engine's right-pad
tokens at prefill and its idle lanes at decode too, as in the reference.
Pads come after every real token in token-major order, so they never
displace one.  A ``Moe`` counts, in a plain host integer, the rows its
expert GEMMs ran (``rows``, E x C a dispatch, E x N a dense call); the
spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(:func:`repro_torch.tracing.span`) mark the four steps while a profiler
records.

Where the reference leans on XLA semantics the port spells them out:
  * ``jax.lax.top_k`` puts the lower expert first on equal probabilities
    (bf16 router logits tie often); ``torch.topk`` promises no order, so
    the top k come from a stable descending sort.
  * The reference's scatter ``mode="drop"`` sends dropped pairs out of
    bounds; here they go to a dummy slot ``E*C`` that is sliced off.
  * The reference's combine is a scatter-add in no set order; here each
    token gathers its k pairs and adds them in k order from zero, with no
    float atomics.  For k <= 2 (every config of the repo) that is the
    scatter-add's result to the bit, and two launches give the same bits.

``REPRO_MOE_PIN`` (read at each call) pins the dispatch buffers' layout
through :func:`repro_torch.sharding.constrain_named`, experts over
"model" and capacity over "data": ``xd`` pins the gathered (E, C, D)
buffer, ``both`` the experts' output too, ``off`` neither.  The default
is ``off``, as the reference's code reads it (its comment names ``xd``
the default; its code does not).  Without an installed
:class:`repro_torch.sharding.activation_constraints` the pin is the
identity.  The expert FFN is XLA in the reference, outside any Pallas
kernel, and stays a batched matmul here.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import constrain_named
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


#: The dispatch buffer's logical layout under ``REPRO_MOE_PIN``.
PIN_LOGICAL = ("experts", "act_capacity", None)


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
    MLP ``shared``."""

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
            self.shared = layers.Mlp(d, f, dtype, device)
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

    def _ffn(self, xd: torch.Tensor) -> torch.Tensor:
        """The experts' gated MLP on (E, C, D) buffers, one batched matmul a
        weight."""
        self.rows += xd.shape[0] * xd.shape[1]
        with span("moe.experts"):
            h = torch.bmm(xd, self.wi.to(xd.dtype))
            g = layers.gate_act(torch.bmm(xd, self.wg.to(xd.dtype)),
                                self.cfg.mlp_act)
            return torch.bmm(h * g, self.wo.to(xd.dtype))

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
        dropped pairs contributing zero."""
        e, k = self.cfg.n_experts, self.cfg.top_k
        n, d = xf.shape
        c = capacity(n, self.cfg)
        pin = os.environ.get("REPRO_MOE_PIN", "off")
        with span("moe.dispatch"):
            slot = self.slots(expert_idx, c)
            pair_token = torch.arange(n * k, device=xf.device) // k
            # The dummy slot e*c takes every dropped pair and is sliced off;
            # the capacity rows no pair fills read the zero row n of x_pad.
            dispatch_tok = torch.full((e * c + 1,), n, dtype=torch.long,
                                      device=xf.device)
            dispatch_tok[slot] = pair_token
            slot_gate = torch.zeros(e * c + 1, dtype=torch.float32,
                                    device=xf.device)
            slot_gate[slot] = gates.reshape(-1)
            x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
            xd = x_pad[dispatch_tok[:e * c]].reshape(e, c, d)
            if pin in ("xd", "both"):
                xd = constrain_named(xd, PIN_LOGICAL)
        yd = self._ffn(xd)
        with span("moe.combine"):
            if pin == "both":
                yd = constrain_named(yd, PIN_LOGICAL)
            yd = yd.reshape(e * c, d)
            yw = yd * slot_gate[:e * c, None].to(yd.dtype)
            yw = torch.cat([yw, yw.new_zeros((1, d))], dim=0)
            pairs = yw[slot].reshape(n, k, d)
            y = torch.zeros((n, d), dtype=xf.dtype, device=xf.device)
            for j in range(k):
                y = y + pairs[:, j].to(xf.dtype)
        return y

    def slots(self, expert_idx: torch.Tensor, c: int) -> torch.Tensor:
        """Each (token, k) pair's buffer slot ``expert * c + position``,
        positions counted in token-major order; ``E * c`` (dropped) where
        the position reaches ``c``."""
        e = self.cfg.n_experts
        e_flat = expert_idx.reshape(-1)
        # (E, N*K), so the running count is a scan along contiguous rows
        onehot = (e_flat == torch.arange(e, device=e_flat.device)[:, None])
        pos = (torch.cumsum(onehot, dim=1) - 1).gather(0, e_flat[None])[0]
        return torch.where(pos < c, e_flat * c + pos, e * c)
