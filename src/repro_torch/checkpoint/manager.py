"""Checkpoint manager (port of ``repro/checkpoint/manager.py``): atomic,
integrity-checked, keep-k, the reference's on-disk layout.

The contract (DESIGN.md §4), as in the reference:
  * writes go to ``<dir>/tmp.step_N`` and are renamed atomically to
    ``step_N`` — a preempted writer never corrupts the latest valid
    checkpoint;
  * ``step_N/arrays.npz`` holds every array, and ``manifest.json`` its
    shape, dtype and SHA-256 digest; loads verify them;
  * the latest step is found by scanning valid manifests (not a symlink),
    so a torn write is skipped on restart;
  * ``CheckpointManager`` keeps the last ``keep`` steps and saves every
    ``every_steps``.

The reference's manifest also records a jax treedef, which nothing
without jax can read, so the port restores **by the flat array names**:
:func:`load_checkpoint` returns ``{name: numpy array}`` and
:func:`repro_torch.convert.train_state_from_flat` builds the train state
from the names the reference writes (``0/<param path>``, ``1/.step``,
``1/.m/...``, ``1/.v/...``, ``2``, ``3``).  So the port resumes a
checkpoint the reference's ``TrainSession`` wrote.  The port's own
manifests carry ``"treedef_kind": "names"`` and no treedef: the
reference cannot read them (ROADMAP §1 item 1.4).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np


def tree_to_flat(tree, prefix: str = "") -> dict:
    """``{name: leaf}`` of a tree of dicts, lists, tuples and NamedTuples,
    named as the reference's ``_tree_to_flat`` names them: dict keys and
    sequence indices joined by "/", a NamedTuple's fields as ``.field``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: dict = {}
    for name, v in items:
        out.update(tree_to_flat(v, f"{prefix}/{name}" if prefix else name))
    return out


def save_checkpoint(ckpt_dir: str, step: int, flat: dict,
                    metadata: Optional[dict] = None) -> str:
    """Write ``{name: array}`` (or a tree, named by :func:`tree_to_flat`)
    as ``step_N``, through ``tmp.step_N`` and an atomic rename; returns the
    step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.step_{step:08d}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: np.asarray(v) for k, v in tree_to_flat(flat).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
                   for k, v in flat.items()},
        "treedef": None,
        "treedef_kind": "names",
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _valid_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, name,
                                                                    "manifest.json")):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    verify: bool = True) -> tuple[int, dict]:
    """The latest (or the given) step and its ``{name: numpy array}``, in
    the manifest's order.  A digest mismatch or an unreadable archive
    raises ``IOError``; no valid step raises ``FileNotFoundError``."""
    steps = _valid_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no valid checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = list(manifest["arrays"])
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            arrays = {name: data[name] for name in names}
    except Exception as e:  # torn/corrupt archive -> uniform IOError
        raise IOError(f"checkpoint corruption reading {path}: {e}") from e
    if verify:
        for name, arr in arrays.items():
            if hashlib.sha256(arr.tobytes()).hexdigest() != manifest["arrays"][name]["sha256"]:
                raise IOError(f"checkpoint corruption: {name} digest mismatch")
    return step, arrays


class CheckpointManager:
    """Keep-k rotation + auto-resume + preemption-safe cadence.  A rank
    that is not the ``writer`` keeps the cadence and makes the arrays (a
    tensor-parallel state is gathered whole, a collective every rank of the
    ``model`` axis joins) but writes nothing: rank 0 writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every_steps: int = 100,
                 writer: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.every_steps = every_steps
        self.writer = writer

    def maybe_save(self, step: int, flat, metadata: Optional[dict] = None,
                   force: bool = False):
        """Save at every ``every_steps``-th step (or when ``force``);
        ``flat`` may be a callable making the ``{name: array}`` dict, so
        the steps that do not save copy nothing to the host."""
        if not force and step % self.every_steps != 0:
            return None
        flat = flat() if callable(flat) else flat
        if not self.writer:
            return None
        path = save_checkpoint(self.ckpt_dir, step, flat, metadata)
        for old in _valid_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{old:08d}"), ignore_errors=True)
        return path

    def restore_or_none(self):
        try:
            return load_checkpoint(self.ckpt_dir)
        except FileNotFoundError:
            return None

    def latest_step(self) -> Optional[int]:
        steps = _valid_steps(self.ckpt_dir)
        return steps[-1] if steps else None
