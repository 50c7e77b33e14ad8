"""Noise sources: every random draw of the closed loop, as an operand.

The reference draws from a JAX key chain inside its jitted scan; the port
never reproduces threefry.  Instead each draw is asked of a noise source:

* ``gumbel(t, (R, A))`` — the action categorical of a selecting tick
  (``argmax(log p + gumbel)``),
* ``replay_indices(t, size, batch)`` — the (R, batch) replay draws of the
  slow step at boundary tick ``t``, uniform in ``[0, max(size_r, 1))``,
* ``env_uniforms(t, (R, K))`` — the two uniform arrays of window ``t``'s
  restart draw (fire, duration),
* ``normal(t, (R, A))`` — the standard-normal sampling noise of the
  Thompson bandit's selecting tick ``t``.

:class:`GeneratorNoise` draws them from a seeded ``torch.Generator``; a
test hands the engine a source that replays the reference's draws instead.
A source whose draws depend on its history (a generator drawn in call
order) also has ``get_state()`` / ``set_state(state)``: a resumed run
restores the position the interrupted one reached, and a control run
restarts from the position its twin started at.  Sources indexed by ``t``
alone need neither.

A sharded run sees one source through :class:`RowBlockNoise`: each draw is
made once at the true fleet size R, padded to the sharded fleet's phantom
rows and handed to each shard as its block of rows, so the numbers a cell
gets, and a generator's call order, do not depend on the shard count.
"""
from __future__ import annotations

from typing import Protocol

import torch


class Noise(Protocol):
    def gumbel(self, t: int, shape: tuple[int, ...]) -> torch.Tensor: ...

    def replay_indices(self, t: int, size: torch.Tensor,
                       batch: int) -> torch.Tensor: ...

    def env_uniforms(self, t: int, shape: tuple[int, ...]
                     ) -> tuple[torch.Tensor, torch.Tensor]: ...

    def normal(self, t: int, shape: tuple[int, ...]) -> torch.Tensor: ...


def get_state(noise):
    """``noise``'s position (None for a source indexed by ``t`` alone)."""
    fn = getattr(noise, "get_state", None)
    return None if fn is None else fn()


def set_state(noise, state) -> None:
    """Move ``noise`` back to a position :func:`get_state` returned."""
    if state is not None:
        noise.set_state(state)


def replay_from_uniform(u: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """(R, batch) replay indices uniform in ``[0, max(size_r, 1))`` from
    (R, batch) uniforms in [0, 1)."""
    hi = torch.clamp(size, min=1)[:, None]
    return torch.minimum((u * hi).long(), hi - 1)


class GeneratorNoise:
    """All draws from one ``torch.Generator`` on ``device``, in call order."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def gumbel(self, t: int, shape: tuple[int, ...]) -> torch.Tensor:
        u = torch.clamp(self._uniform(shape),
                        min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def replay_uniform(self, t: int, shape: tuple[int, ...]) -> torch.Tensor:
        """The uniforms :meth:`replay_indices` scales by the replay sizes."""
        return self._uniform(shape)

    def replay_indices(self, t: int, size: torch.Tensor,
                       batch: int) -> torch.Tensor:
        return replay_from_uniform(
            self.replay_uniform(t, (size.shape[0], batch)), size)

    def env_uniforms(self, t: int, shape: tuple[int, ...]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        return self._uniform(shape), self._uniform(shape)

    def normal(self, t: int, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def get_state(self) -> torch.Tensor:
        """The generator's state: a CPU ``uint8`` tensor, for a CUDA
        generator too, so a checkpoint can hold it as a leaf."""
        return self.gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.gen.set_state(state.cpu())


class RowBlockNoise:
    """One noise source seen by the shards of a padded fleet.

    ``n_true`` cells padded to ``r_local * n_shards`` rows; shard ``d`` owns
    rows ``[d * r_local, (d + 1) * r_local)`` on ``mesh[d]`` and draws
    through :meth:`block`.  Each draw of tick ``t`` is made once from
    ``noise`` at the true R, padded to the phantom rows (restart uniforms
    with 1.0, which no restart probability reaches; Gumbel, normal and
    replay draws with the last real row's) and kept until :meth:`clear`,
    which the engine calls before each tick or window: every shard reads
    its rows of the same draw.

    Replay indices depend on each row's replay size.  A source with
    ``replay_uniform`` (:class:`GeneratorNoise`) gives the uniforms once at
    the true R and each shard scales its rows by its own sizes; a source
    indexed by ``t`` alone (no ``get_state``) is asked again for each shard
    with that shard's sizes on its rows, and each row's draw depends on its
    own size alone.
    """

    def __init__(self, noise, n_true: int, r_local: int,
                 mesh: list[torch.device]):
        if not hasattr(noise, "replay_uniform") and \
                hasattr(noise, "get_state"):
            raise ValueError(
                "a noise source whose draws depend on its history needs "
                "replay_uniform(t, shape) to be shared between shards")
        self.noise, self.n_true, self.r_local = noise, n_true, r_local
        self.mesh = list(mesh)
        self.n_pad = r_local * len(self.mesh)
        self._cache = {}

    def block(self, d: int) -> "_Block":
        return _Block(self, d)

    def clear(self) -> None:
        self._cache.clear()

    def get_state(self):
        return get_state(self.noise)

    def set_state(self, state) -> None:
        self.clear()
        set_state(self.noise, state)

    def _pad(self, x: torch.Tensor, fill: float | None) -> torch.Tensor:
        extra = self.n_pad - self.n_true
        if not extra:
            return x
        tail = (x[-1:].expand((extra,) + tuple(x.shape[1:])) if fill is None
                else x.new_full((extra,) + tuple(x.shape[1:]), fill))
        return torch.cat([x, tail])

    def _full(self, kind: str, t: int, draw, fill: float | None):
        key = (kind, t)
        if key not in self._cache:
            x = draw()
            self._cache[key] = (tuple(self._pad(v, fill) for v in x)
                                if isinstance(x, tuple) else
                                self._pad(x, fill))
        return self._cache[key]


class _Block:
    """Shard ``d``'s view of a :class:`RowBlockNoise` (a ``Noise``)."""

    def __init__(self, group: RowBlockNoise, d: int):
        self.group, self.d = group, d
        self.lo = d * group.r_local
        self.device = group.mesh[d]

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.lo:self.lo + self.group.r_local].to(self.device)

    def _check(self, shape) -> tuple:
        if shape[0] != self.group.r_local:
            raise ValueError(f"a shard draws {self.group.r_local} rows, "
                             f"asked for {shape[0]}")
        return (self.group.n_true,) + tuple(shape[1:])

    def gumbel(self, t: int, shape) -> torch.Tensor:
        g = self.group
        full = self._check(shape)
        return self._rows(g._full("gumbel", t,
                                  lambda: g.noise.gumbel(t, full), None))

    def normal(self, t: int, shape) -> torch.Tensor:
        g = self.group
        full = self._check(shape)
        return self._rows(g._full("normal", t,
                                  lambda: g.noise.normal(t, full), None))

    def env_uniforms(self, t: int, shape):
        g = self.group
        full = self._check(shape)
        pair = g._full("env", t, lambda: tuple(g.noise.env_uniforms(t, full)),
                       1.0)
        return tuple(self._rows(x) for x in pair)

    def replay_indices(self, t: int, size: torch.Tensor,
                       batch: int) -> torch.Tensor:
        g = self.group
        full = self._check((size.shape[0], batch))
        if hasattr(g.noise, "replay_uniform"):
            u = g._full("replay", t,
                        lambda: g.noise.replay_uniform(t, full), None)
            return replay_from_uniform(self._rows(u).to(size.device), size)
        # a source indexed by t: this shard's sizes on its own rows (a
        # shard of phantom rows alone asks with its size at the last real
        # row, whose draw they copy)
        real = max(min(g.n_true - self.lo, g.r_local), 0)
        sizes = torch.ones(g.n_true, dtype=size.dtype)
        sizes[self.lo:self.lo + real] = size[:real].cpu()
        if not real:
            sizes[-1] = size[0].cpu()
        idx = g._pad(g.noise.replay_indices(t, sizes, batch), None)
        return self._rows(idx).to(size.device)
