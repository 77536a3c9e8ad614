"""Step-indexed npz checkpoints (counterpart of
``topk_rec_tpu/checkpoint.py``).

Only the JAX package's npz path is ported, in the same format: one
``step_{N:08d}.npz`` per saved step under a root directory, holding the
nested dictionary flattened to ``/``-joined keys (``params/ue``,
``ms/ie``, ...). The JAX ``CheckpointManager`` reads these files (it takes
the npz path wherever no orbax directory exists for the step), and this one
reads the npz files that the JAX package writes without orbax. ``keep``
bounds the npz steps retained; ``save_every`` skips steps off that cadence
unless ``force`` is set.

Where orbax imports, the JAX package writes ``step_{N:08d}/`` directories
instead, which only orbax, and so only JAX, can read. This manager counts
them as steps, so that it never resumes from an older npz step past them
or trains from scratch beside them without a word: restoring such a step
(and ``latest_step`` when the newest step is one) raises
:class:`OrbaxCheckpointError`, and ``_gc`` leaves them alone.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class OrbaxCheckpointError(RuntimeError):
    """A step is held as an orbax directory of the JAX package."""


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flatten(val, f"{prefix}{key}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


class CheckpointManager:
    """Checkpoints of a nested dictionary of tensors or arrays."""

    def __init__(self, root: str, keep: int = 3, save_every: int = 1):
        self.root = os.path.abspath(root)
        self.keep = keep
        self.save_every = save_every
        os.makedirs(self.root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}.npz")

    def _found(self, orbax: bool) -> List[int]:
        """Steps held as npz files, or (``orbax``) as directories only."""
        steps = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)(\.npz)?", name)
            if m is None:
                continue
            path = os.path.join(self.root, name)
            if orbax:
                held = (m.group(2) is None and os.path.isdir(path)
                        and not os.path.exists(path + ".npz"))
            else:
                held = m.group(2) is not None
            if held:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def steps(self) -> List[int]:
        """Every saved step: npz files and the JAX package's orbax
        directories."""
        return sorted(self._found(False) + self._found(True))

    def _refuse(self, step: int) -> OrbaxCheckpointError:
        return OrbaxCheckpointError(
            f"{os.path.join(self.root, f'step_{step:08d}')} holds an orbax "
            "checkpoint of the JAX package (topk_rec_tpu), which "
            "topk_rec_torch cannot read (it reads step_N.npz files only). "
            "Resume that run with the JAX package, or start a fresh run "
            "with --ckpt-dir set to another directory."
        )

    def latest_step(self) -> Optional[int]:
        """The newest step, or None; raises OrbaxCheckpointError when the
        newest step is an orbax directory."""
        steps = self.steps()
        if steps and steps[-1] in self._found(True):
            raise self._refuse(steps[-1])
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Save if ``step`` is on the ``save_every`` cadence (or ``force``);
        returns whether it saved."""
        if not force and step % self.save_every != 0:
            return False
        np.savez(self._path(step), **_flatten(tree))
        self._gc()
        return True

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The nested dictionary of numpy arrays of ``step`` (default: the
        latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        if step in self._found(True):
            raise self._refuse(step)
        with np.load(self._path(step)) as data:
            return _unflatten(dict(data))

    def _gc(self) -> None:
        steps = self._found(False)  # never an orbax directory
        for old in steps[: -self.keep] if self.keep else []:
            os.remove(self._path(old))
