"""Checkpoints of a run's state: one file per leaf, a checksummed manifest.

Format: one directory per step, ``step_<8 digits>``, holding one
``torch.save`` file per tensor leaf of the saved tree (leaves named by
their path through NamedTuples, dicts and tuples) and ``manifest.json``:
each leaf's file, dtype, shape and SHA-256, plus the caller's ``extra``.

* **async save** — the leaves are copied to host memory first (the caller
  may go on updating its tensors in place), then written on a background
  thread; :meth:`Checkpointer.wait` joins it;
* **atomicity** — a step is written into ``<dir>.tmp``, each file
  fsync'd, the manifest last through its own tmp file and an atomic
  replace, and the directory lands by an atomic rename: a step without a
  manifest is never listed;
* **rotation** — the newest ``keep_n`` steps are kept;
* **corruption fallback** — :meth:`Checkpointer.restore` with ``step=None``
  walks the steps newest-first and falls back past one it cannot read (a
  torn or altered leaf fails its checksum, a manifest that does not parse)
  with a ``RuntimeWarning``; a named step stays strict.  Leaves are loaded
  with ``weights_only=True`` onto the device of the template's leaf, or
  onto ``device`` where that leaf is on ``meta`` (a template that
  allocates nothing).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import warnings
from typing import Any

import torch


class CorruptCheckpointError(RuntimeError):
    """A checkpoint directory exists but cannot be restored (torn or altered
    leaf, missing file, unreadable manifest, shape drift)."""


def _children(tree):
    if hasattr(tree, "_asdict"):
        return tree._asdict().items()
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (tuple, list)):
        return enumerate(tree)
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensor leaves of ``tree`` by path (None leaves are skipped)."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for key, sub in _children(tree):
        out.update(flatten(sub, _join(prefix, key)))
    return out


def unflatten(like, leaves: dict[str, torch.Tensor], prefix: str = ""):
    """A tree shaped like ``like`` with its tensors taken from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return leaves[prefix]
    if hasattr(like, "_asdict"):
        return type(like)(**{k: unflatten(v, leaves, _join(prefix, k))
                             for k, v in like._asdict().items()})
    if isinstance(like, dict):
        return {k: unflatten(v, leaves, _join(prefix, k))
                for k, v in like.items()}
    return type(like)(unflatten(v, leaves, _join(prefix, i))
                      for i, v in enumerate(like))


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``; asynchronous unless ``blocking``."""
        self.wait()
        flat = {k: v.detach().to("cpu", copy=True)
                for k, v in flatten(tree).items()}

        def write():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}, "extra": extra or {}}
            for name, t in flat.items():
                buf = io.BytesIO()
                torch.save(t, buf)
                data = buf.getvalue()
                fn = name.replace("/", "__") + ".pt"
                _write_synced(os.path.join(tmp, fn), data)
                manifest["leaves"][name] = {
                    "file": fn, "dtype": str(t.dtype).removeprefix("torch."),
                    "shape": list(t.shape),
                    "sha256": hashlib.sha256(data).hexdigest()}
            # the manifest lands last, through its own atomic replace: its
            # presence says every leaf landed
            mpath = os.path.join(tmp, "manifest.json")
            _write_synced(mpath + ".tmp", json.dumps(manifest).encode())
            os.replace(mpath + ".tmp", mpath)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._rotate()

        if blocking:
            write()
            return

        def background():
            try:
                write()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _rotate(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Steps whose directory landed with a manifest, oldest first."""
        out = []
        for d in os.listdir(self.directory):
            if (d.startswith("step_") and not d.endswith(".tmp")
                    and os.path.exists(os.path.join(self.directory, d,
                                                    "manifest.json"))):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        """The newest step that landed with a manifest (None if none has)."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: int | None = None,
                device: str | torch.device | None = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors whose
        shapes, dtypes and devices the restored leaves take; a leaf of
        ``like`` on the ``meta`` device is loaded onto ``device``).

        With ``step=None`` the steps are tried newest-first and an
        unreadable one is skipped with a ``RuntimeWarning``; when every step
        is unreadable :class:`CorruptCheckpointError` names them all.  A
        named ``step`` raises on the first fault.

        Returns (tree, extra).
        """
        self.wait()
        if step is not None:
            return self._restore_at(step, like, device)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory!r}")
        errors = []
        for s in reversed(steps):
            try:
                return self._restore_at(s, like, device)
            except CorruptCheckpointError as e:
                errors.append((s, str(e)))
                warnings.warn(
                    f"checkpoint step {s} under {self.directory!r} is "
                    f"unreadable ({e}); falling back to the previous one",
                    RuntimeWarning, stacklevel=2)
        raise CorruptCheckpointError(
            f"all {len(steps)} checkpoints under {self.directory!r} are "
            f"unreadable: {errors}")

    def _restore_at(self, step: int, like, device) -> tuple[Any, dict]:
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            entries, extra = manifest["leaves"], manifest["extra"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise CorruptCheckpointError(
                f"step {step}: manifest unreadable: {e!r}") from e
        leaves = {}
        for name, ref in flatten(like).items():
            info = entries.get(name)
            if info is None:
                raise CorruptCheckpointError(
                    f"step {step}: leaf {name!r} missing from the manifest")
            try:
                with open(os.path.join(d, info["file"]), "rb") as f:
                    data = f.read()
            except OSError as e:
                raise CorruptCheckpointError(
                    f"step {step}: leaf {name!r} unreadable: {e}") from e
            if hashlib.sha256(data).hexdigest() != info["sha256"]:
                raise CorruptCheckpointError(
                    f"step {step}: leaf {name!r} fails its checksum (torn "
                    f"or altered file)")
            where = device if ref.is_meta and device is not None else ref.device
            t = torch.load(io.BytesIO(data), weights_only=True,
                           map_location=where)
            if tuple(t.shape) != tuple(ref.shape):
                raise CorruptCheckpointError(
                    f"step {step}: {name}: checkpoint shape "
                    f"{list(t.shape)} vs template {list(ref.shape)}")
            leaves[name] = t.to(ref.dtype)
        return unflatten(like, leaves), extra
