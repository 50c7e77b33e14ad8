"""Deterministic synthetic LM data: shardable and resumable (the port of
``repro/data/pipeline.py``).

Each host draws its shard of the global batch from draws that depend only
on ``(seed, step, host_id)``, so every host produces disjoint,
deterministic data, and restoring an iterator is restoring its integer
step: a restarted job resumes mid-stream with no drift.

The token stream is an LCG successor sequence, ``token_{t+1} = (131
token_t + 17) mod V`` from a random start ``s0`` per row, so the loss has
learnable signal; the labels are the tokens rolled left by one (the last
label wraps round to the row's first token, as in the reference).

The reference draws ``s0`` and the embeddings with threefry keys folded
from the step and host; the port never reproduces threefry.  It seeds a
``torch.Generator`` on the CPU from ``(seed, step, host_id)`` instead (the
same draws whatever device the batch goes to), or takes the draws as an
operand: ``draws(step, host_id) -> (s0 (per_host, 1), embeds or None)``,
through which the tests feed the reference's own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

Draws = Callable[[int, int], tuple]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    input_mode: str = "tokens"     # tokens | embeddings (audio stub)
    d_model: int = 0               # for embeddings mode


class SyntheticPipeline:
    """Stateful iterator with explicit (step) state for checkpointing.

    Batches are dicts of tensors on ``device``: ``tokens`` and ``labels``
    (per_host, seq_len) int64, and in embeddings mode ``embeds``
    (per_host, seq_len, d_model) float32."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0, device: str | torch.device = "cuda",
                 draws: Draws | None = None):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = start_step
        self.device = resolve_device(device)
        self.draws = draws or self.generator_draws
        self._coeffs = self._lcg_coeffs()

    # --------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, host_id: int = 0,
                n_hosts: int = 1, **kwargs) -> "SyntheticPipeline":
        assert state["seed"] == cfg.seed, "seed mismatch on restore"
        return cls(cfg, host_id, n_hosts, start_step=int(state["step"]),
                   **kwargs)

    # --------------------------------------------------------------- data
    def _lcg_coeffs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """token_k = (a^k s0 + c sum_{j<k} a^j) mod V, a deterministic
        LCG."""
        v, a, c = self.cfg.vocab_size, 131, 17
        ak = torch.zeros(self.cfg.seq_len, dtype=torch.int64)
        ck = torch.zeros(self.cfg.seq_len, dtype=torch.int64)
        x, s = 1, 0
        for k in range(self.cfg.seq_len):
            ak[k], ck[k] = x, (c * s) % v
            s = (s + x) % v
            x = (x * a) % v
        return ak, ck

    def generator_draws(self, step: int, host_id: int):
        """s0 (per_host, 1) in [0, V) and, in embeddings mode, standard
        normal embeds, from a CPU generator seeded by (seed, step,
        host_id)."""
        cfg = self.cfg
        per_host = cfg.global_batch // self.n_hosts
        seed = np.random.SeedSequence(
            [cfg.seed, step, host_id]).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        s0 = torch.randint(0, cfg.vocab_size, (per_host, 1), generator=gen)
        embeds = (torch.randn((per_host, cfg.seq_len, cfg.d_model),
                              generator=gen)
                  if cfg.input_mode == "embeddings" else None)
        return s0, embeds

    def _batch_for(self, step: int) -> dict:
        cfg = self.cfg
        s0, embeds = self.draws(step, self.host_id)
        ak, ck = self._coeffs
        s0 = torch.as_tensor(s0, dtype=torch.int64).reshape(-1, 1)
        tokens = (s0 * ak[None, :] + ck[None, :]) % cfg.vocab_size
        out = {"tokens": tokens.to(self.device),
               "labels": torch.roll(tokens, -1, dims=1).to(self.device)}
        if cfg.input_mode == "embeddings":
            out["embeds"] = torch.as_tensor(embeds, dtype=torch.float32).to(
                self.device)
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._batch_for(self.step)
        self.step += 1
        return b
