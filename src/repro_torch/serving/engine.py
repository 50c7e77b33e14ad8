"""Slot-based serving engine with continuous batching (the port of
``repro/serving/engine.py``).

One engine wraps a model and maintains ``max_batch`` decode slots:

  * requests are admitted from a FIFO queue into free slots — admission runs
    a b=1 prefill of the prompt right-padded to a power-of-two bucket (at
    least 16, at most ``max_len``) and splices the resulting caches into the
    slot's batch lane in place;
  * every ``step()`` runs ONE batched decode for all slots at their own
    positions (a (B,) position tensor: kernel B5 masks each sequence at its
    own length), greedy-samples, and retires slots that hit
    ``max_new_tokens`` or the cache's end;
  * on the card the engine runs its first wave eagerly, then records that
    wave (the model's decode step and the argmax that feeds the next) as
    one CUDA graph and replays it for every later wave: the wave always has
    ``max_batch`` lanes, the caches are written in place, and its inputs
    (the tokens, the positions) and its output (the next tokens) live in
    buffers the engine owns.  Recording runs nothing, so no cache moves
    twice.  A model whose decode step waits on the host keeps the eager
    wave, as the model reports (``decode_capturable``: an MoE layer whose
    grouped products run in float32 copies their offsets to the host).  On
    the CPU every wave is eager;
  * the engine exports queue depth and utilization so an AIF router can sit
    in front of a *fleet* of engines (:mod:`repro_torch.serving.multitier`).

Counters (plain host integers, always on; a caller takes the difference of
two :meth:`ServingEngine.counters` snapshots): steps, decode waves, the real
prompt tokens and the bucket tokens prefilled, the lanes each wave computes
(``max_batch``) and the live ones among them, and the keys kernel B5 is
asked to read, summed over the layers (the model's ``decode_keys``, from
each layer's :class:`repro_torch.models.attention.KVLayout`; retired and
never-used lanes at their last position too), and those of live lanes,
and the waves served by replaying the graph (``graph_waves``).  Requests
carry ``submitted_at``, ``admitted_at`` and ``finished_at`` on
``time.perf_counter()``.  The model's layers keep counters of their own
(:mod:`repro_torch.tracing`).  A replayed wave runs no Python of the model:
whatever the recorded wave counted through :func:`repro_torch.tracing.count`
is added again at each replay.  Kernel B5's ``launches`` counts its
wrapper's calls, so the recording once and no replay: a device trace
counts the replays' kernels.

Spans (:func:`repro_torch.tracing.span`, recorded while a profiler is on),
nested as they run; the model's own, inside ``engine.prefill`` and
``engine.decode``, are listed in :mod:`repro_torch.tracing`::

    engine.admit                            ServingEngine._admit
      engine.prefill                        the model's prefill
      engine.splice                         the b=1 caches into the slot
      engine.first_token                    argmax + int(): waits for it
    engine.wave                             the decode half of step()
      engine.decode                         the model's decode + argmax:
                                            enqueued (a graph's replay)
      engine.sample                         host copy of the tokens: waits
      engine.retire                         the per-slot bookkeeping

A replayed wave has ``engine.decode`` around the replay and none of the
model's spans inside it: those mark the eager first wave only.

Attention caches are linear in the engine (``serve_ring_caches=False``):
admission right-pads prompts into its buckets, whose pads a ring would
keep in place of the prompt's last keys.  On the card every prefill
attention is kernel B4, every decode attention kernel B5 and every Mamba-2
prefill scan kernel B6; on the CPU their plain versions.  A Mamba layer's
prefill runs over the whole padded bucket but is given the prompt's real
length: the pads' steps are 0 and its conv state is taken from the last
real inputs, so the state it hands to decode is that of the real prompt
(ROADMAP R5, repaired in the port; the reference's state still sees the
pads).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import model_from_state_dict
from repro_torch.tracing import span


@dataclasses.dataclass
class Request:
    id: int
    tokens: list
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    output: list = dataclasses.field(default_factory=list)


class ServingEngine:
    """``params``: a ``state_dict`` of the model (e.g. from
    :func:`repro_torch.models.convert.params_from_numpy`, or another
    engine's ``model.state_dict()``); its tensors become the model's
    parameters, so engines built from one state dict on one device share
    their weights.  Without it the engine draws random weights from its own
    ``torch.Generator(seed)``.  ``speed_factor`` is stored as the
    reference stores it and read by nothing: it has no effect on the port's
    timing."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 speed_factor: float = 1.0, name: str = "engine",
                 device: str | torch.device = "cuda"):
        cfg = dataclasses.replace(cfg, serve_ring_caches=False)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = (build_model(cfg, self.device, seed) if params is None
                      else model_from_state_dict(cfg, params, self.device))
        self.max_batch = max_batch
        self.max_len = max_len
        self.name = name
        self.speed_factor = speed_factor   # relative tier capacity (sim time)

        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * max_batch
        # the lanes' positions are host integers in (on the card, pinned)
        # memory that each wave copies to the device buffer it reads
        on_card = self.device.type == "cuda"
        self._pos_host = torch.zeros(max_batch, dtype=torch.int32,
                                     pin_memory=on_card)
        self.positions = self._pos_host.numpy()
        self._pos = torch.zeros(max_batch, dtype=torch.int32,
                                device=self.device)
        self.remaining = np.zeros(max_batch, dtype=np.int32)
        self.caches = self.model.init_caches(max_batch, max_len)
        self.last_tokens = torch.zeros((max_batch, 1), dtype=torch.int64,
                                       device=self.device)
        self._graphed: Optional[bool] = None   # decided at the first wave
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_counts: list = []     # what the recorded wave counted
        self.completed: list[Request] = []
        self.steps = 0
        self.busy_steps = 0        # decode waves
        self.prompt_tokens = 0
        self.bucket_tokens = 0
        self.lanes = 0
        self.live_lanes = 0
        self.b5_keys = 0
        self.live_keys = 0
        self.graph_waves = 0

    # ----------------------------------------------------------------- API
    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.active)

    def utilization(self) -> float:
        return self.busy_steps / max(self.steps, 1)

    def counters(self) -> dict:
        """A snapshot of the engine's counters (see the module docstring)."""
        return {"steps": self.steps, "waves": self.busy_steps,
                "prompt_tokens": self.prompt_tokens,
                "bucket_tokens": self.bucket_tokens, "lanes": self.lanes,
                "live_lanes": self.live_lanes, "b5_keys": self.b5_keys,
                "live_keys": self.live_keys, "graph_waves": self.graph_waves}

    # ------------------------------------------------------------ admission
    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _admit(self, slot: int, req: Request):
        with span("engine.admit"):
            req.admitted_at = time.perf_counter()
            n = len(req.tokens)
            bucket = self._bucket(n)
            self.prompt_tokens += n
            self.bucket_tokens += bucket
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :n] = req.tokens[:bucket]
            with span("engine.prefill"):
                logits, caches1 = self.model.prefill(
                    torch.from_numpy(toks).to(self.device),
                    max_len=self.max_len, last_index=n - 1)
            with span("engine.splice"):
                _write_slot(self.caches, caches1, slot)
            with span("engine.first_token"):
                first = torch.argmax(logits[:, -1], dim=-1)
                self.last_tokens[slot, 0] = first[0]
                req.output.append(int(first[0]))
        self.active[slot] = req
        self.positions[slot] = n
        self.remaining[slot] = req.max_new_tokens - 1

    # ---------------------------------------------------------------- step
    def step(self) -> list[Request]:
        """Admit + one decode wave.  Returns requests finished this step."""
        self.steps += 1
        for slot in range(self.max_batch):
            if self.active[slot] is None and self.queue:
                self._admit(slot, self.queue.popleft())

        if self.active_count == 0:
            return []
        with span("engine.wave"):
            self.busy_steps += 1
            keys = self.model.decode_keys(self.caches, self.positions)
            live = np.array([r is not None for r in self.active])
            self.lanes += self.max_batch
            self.live_lanes += int(live.sum())
            self.b5_keys += int(keys.sum())
            self.live_keys += int(keys[live].sum())

            with span("engine.decode"):
                # no wait: the wave's host copy of its tokens waits for this
                # copy too, before the host writes the positions again
                self._pos.copy_(self._pos_host, non_blocking=True)
                if self._graph is not None:
                    self._replay()
                else:
                    self._decode()
                    if self._graphed is None:
                        self._graphed = (
                            self.device.type == "cuda"
                            and self.model.decode_capturable(self.max_batch))
                    if self._graphed:
                        self._capture()
            with span("engine.sample"):
                nxt = self.last_tokens[:, 0].cpu().numpy()
            finished = []
            with span("engine.retire"):
                for slot, req in enumerate(self.active):
                    if req is None:
                        continue
                    req.output.append(int(nxt[slot]))
                    self.positions[slot] += 1
                    self.remaining[slot] -= 1
                    if (self.remaining[slot] <= 0
                            or self.positions[slot] >= self.max_len - 1):
                        req.finished_at = time.perf_counter()
                        self.completed.append(req)
                        finished.append(req)
                        self.active[slot] = None
            return finished

    # --------------------------------------------------------- decode wave
    def _decode(self) -> None:
        """One decode step of every lane at its position; the greedy next
        tokens are written into ``last_tokens``."""
        logits, _ = self.model.decode_step(self.last_tokens, self.caches,
                                           self._pos)
        torch.argmax(logits[:, 0], dim=-1, keepdim=True, out=self.last_tokens)

    def _capture(self) -> None:
        """Record :meth:`_decode` as a CUDA graph, and what it counted.
        Recording runs nothing, so the caches stay as the eager wave left
        them."""
        graph = torch.cuda.CUDAGraph()
        with tracing.counts_made() as counts, torch.cuda.graph(graph):
            self._decode()
        # the recording ran the wave's Python, not the wave: what it counted
        # is what each replay adds, and is taken back here
        tracing.add_counts(counts, -1)
        self._graph, self._graph_counts = graph, counts

    def _replay(self) -> None:
        """One wave by the recorded graph, its counts added."""
        self._graph.replay()
        tracing.add_counts(self._graph_counts)
        self.graph_waves += 1


def _write_slot(caches: list, caches1: list, slot: int) -> list:
    """Write b=1 prefill caches into batch lane ``slot`` of the engine
    caches (every leaf of each layer's dict), in place."""
    for big, one in zip(caches, caches1):
        for name, t in one.items():
            big[name][slot].copy_(t[0])
    return caches
