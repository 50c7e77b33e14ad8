"""Plain PyTorch versions of the Mamba-2 SSD scan, the port of the oracle in
``repro/models/ssm.py`` (``_segsum``, ``ssd_chunked``, ``ssd_decode_step``).

:func:`ssd_chunked` is what a CPU tensor runs (:mod:`.ops`) and what kernel
B6 (:mod:`.ssd`) is held against on the card; it rounds ``xbar = x * dt``
to x's type before widening it, as the oracle does.  :func:`ssd_decode_step`
is the one-token recurrence of Mamba-2 decode (the reference has no kernel
for it).  ``jnp.repeat`` over groups becomes ``torch.repeat_interleave``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(dta: torch.Tensor) -> torch.Tensor:
    """dta (..., Q) -> (..., Q, Q) lower-triangular decay sums:
    ``out[i, j] = sum_{k=j+1..i} dta[k]`` for i >= j, else -inf."""
    q = dta.shape[-1]
    cs = torch.cumsum(dta, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(q, device=dta.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-duality scan.

    x (B, S, H, P); dt (B, S, H) positive (softplus applied); a (H,)
    negative; b/c (B, S, G, N); chunk Q; init_state optional (B, H, P, N).
    A ragged last chunk is padded with dt=0 steps, exact identities on the
    state.  Returns (y (B, S, H, P), final_state (B, H, P, N)), both in x's
    type.
    """
    bsz, s_orig, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s_orig)
    if s_orig % q:
        pad = q - s_orig % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    s = x.shape[1]
    nc = s // q
    rep = h // g

    f32 = torch.float32
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b.reshape(bsz, nc, q, g, n)
    cc = c.reshape(bsz, nc, q, g, n)
    dta = dtc * a[None, None, None, :]                    # (B,nc,Q,H)

    bh = torch.repeat_interleave(bc, rep, dim=3).to(f32)  # (B,nc,Q,H,N)
    ch = torch.repeat_interleave(cc, rep, dim=3).to(f32)

    # intra-chunk: decay-masked (C B^T) applied to the dt-scaled input
    ll = torch.exp(segsum(dta.movedim(-1, 2)))            # (B,nc,H,Q,Q)
    xbar = (xc * dtc[..., None].to(xc.dtype)).to(f32)     # rounded to x's type
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh)
    y_intra = torch.einsum("bchls,bcshp->bclhp", scores * ll, xbar)

    # chunk-final local states
    cs = torch.cumsum(dta, dim=2)                         # (B,nc,Q,H)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    states_local = torch.einsum("bcshn,bcsh,bcshp->bchpn", bh, decay_to_end,
                                xbar)                     # (B,nc,H,P,N)
    chunk_decay = torch.exp(cs[:, :, -1, :])              # (B,nc,H)

    # inter-chunk recurrence, emitting each chunk's starting state
    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=f32, device=x.device))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = (state * chunk_decay[:, ci, :, None, None]
                 + states_local[:, ci])
    prev_states = torch.stack(prev, dim=1)                # (B,nc,H,P,N)

    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp", ch, torch.exp(cs),
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :s_orig].to(x.dtype)
    return y, state.to(x.dtype)


def _bf16_halves(v: torch.Tensor, keep_lo: bool) -> list[torch.Tensor]:
    """float32 ``v`` as the tensor cores take it: hi = bf16(v) and, when
    ``keep_lo``, lo = bf16(v - hi) (the difference is exact in float32)."""
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()] if keep_lo else [hi]


def ssd_chunk_parallel_model(x: torch.Tensor, dt: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor, chunk: int,
                             init_state: torch.Tensor | None = None, *,
                             split_bf16: bool, keep_lo: bool = True
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """B6's chunk-parallel algebra in float32, in its three phases:

    1. per (batch, chunk, head): cs = cumsum(dt a) and the chunk's local
       state sum_s (xbar_s exp(cs_last - cs_s))^T B_s;
    2. the state passed over the chunks, S_c = exp(cs_last,c) S_{c-1} +
       local_c from ``init_state`` (or zeros), keeping each chunk's start;
    3. per chunk, y_r = exp(cs_r) C_r . S_start^T + sum_{s<=r} ((C_r . B_s)
       exp(cs_r - cs_s)) xbar_s, with C B^T one plane per group.

    With ``split_bf16`` every float32 operand of a tensor-core product
    (xbar exp(cs_last - cs), the decay-masked scores, the carried state)
    enters as two bf16 halves whose products are summed in float32, as the
    bf16 kernel takes them; C, B and xbar (rounded to x's type) are bf16
    already, so on bf16 inputs this is the kernel's arithmetic up to the
    order of its sums.  ``keep_lo=False`` drops the lo halves.  Shapes as
    :func:`ssd_chunked`; returns (y, final state) in float32."""
    bsz, s_orig, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s_orig)
    if s_orig % q:
        pad = q - s_orig % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    rep = h // g
    f32 = torch.float32

    def halves(v):
        return _bf16_halves(v, keep_lo) if split_bf16 else [v]

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bg = b.reshape(bsz, nc, q, g, n).to(f32)
    cg = c.reshape(bsz, nc, q, g, n).to(f32)
    bh = torch.repeat_interleave(bg, rep, dim=3)            # (B,nc,Q,H,N)
    ch = torch.repeat_interleave(cg, rep, dim=3)
    xbar = (xc * dtc[..., None].to(xc.dtype)).to(f32)      # rounded to x's type

    # 1. cumulative decay and each chunk's local state
    cs = torch.cumsum(dtc * a[None, None, None, :], dim=2)  # (B,nc,Q,H)
    xw = xbar * torch.exp(cs[:, :, -1:, :] - cs)[..., None]
    local = sum(torch.einsum("bcshp,bcshn->bchpn", part, bh)
                for part in halves(xw))                     # (B,nc,H,P,N)

    # 2. the state passed from chunk to chunk
    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=f32, device=x.device))
    starts = []
    for ci in range(nc):
        starts.append(state)
        state = state * torch.exp(cs[:, ci, -1, :])[..., None, None] \
            + local[:, ci]
    start = torch.stack(starts, dim=1)                      # (B,nc,H,P,N)

    # 3. each chunk's outputs: the carried state, then the masked scores
    y = sum(torch.einsum("bclhn,bchpn->bclhp", ch, part)
            for part in halves(start)) * torch.exp(cs)[..., None]
    scores = torch.einsum("bclgn,bcsgn->bcgls", cg, bg)    # (B,nc,G,Q,Q)
    scores = torch.repeat_interleave(scores, rep, dim=2)    # (B,nc,H,Q,Q)
    ii = torch.arange(q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    csh = cs.movedim(-1, 2)                                 # (B,nc,H,Q)
    decay = torch.exp(torch.where(causal, csh[..., :, None]
                                  - csh[..., None, :], float("-inf")))
    masked = scores * decay
    y = y + sum(torch.einsum("bchls,bcshp->bclhp", part, xbar)
                for part in halves(masked))
    return y.reshape(bsz, nc * q, h, p)[:, :s_orig], state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, a: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state (B, H, P, N); x_t (B, H, P); dt_t
    (B, H); b_t/c_t (B, G, N).  Returns (y_t in x_t's type, new state in
    state's type)."""
    h = x_t.shape[1]
    rep = h // b_t.shape[1]
    f32 = torch.float32
    bh = torch.repeat_interleave(b_t, rep, dim=1).to(f32)    # (B,H,N)
    ch = torch.repeat_interleave(c_t, rep, dim=1).to(f32)
    da = torch.exp(dt_t.to(f32) * a[None, :])                # (B,H)
    xbar = x_t.to(f32) * dt_t[..., None].to(f32)             # (B,H,P)
    new = (state.to(f32) * da[..., None, None]
           + torch.einsum("bhp,bhn->bhpn", xbar, bh))
    y = torch.einsum("bhn,bhpn->bhp", ch, new)
    return y.to(x_t.dtype), new.to(state.dtype)
