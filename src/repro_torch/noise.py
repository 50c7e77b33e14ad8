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

    def replay_indices(self, t: int, size: torch.Tensor,
                       batch: int) -> torch.Tensor:
        hi = torch.clamp(size, min=1)[:, None]
        u = self._uniform((size.shape[0], batch))
        return torch.minimum((u * hi).long(), hi - 1)

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
