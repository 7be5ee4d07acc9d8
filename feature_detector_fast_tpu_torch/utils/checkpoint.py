"""Checkpoint / resume for SLAM state.

Counterpart of ``feature_detector_fast_tpu.utils.checkpoint`` (Orbax
there).  A state is a nested dict / list / tuple of tensors, numpy arrays
and scalars; ``save_state`` writes it with ``torch.save`` as the file
``directory/step_<n>``, and ``restore_state`` reads it back with
``torch.load(weights_only=True)``, which loads tensors and plain containers
only.  So numpy leaves are stored as tensors (:func:`_arrayify`) and a
template gives them back their form.

A save writes a temporary file in the same directory and renames it over
``step_<n>`` (``os.replace``), so a save cut short leaves no half-written
step for :func:`latest_step` to pick up (Orbax's commit is atomic too), and
a step that exists is overwritten (Orbax's ``force=True``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch


def _arrayify(state):
    """The state with every numpy array and Python / numpy scalar leaf a
    tensor (0-d for scalars), in nested dicts, lists and tuples."""
    if isinstance(state, dict):
        return {k: _arrayify(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_arrayify(v) for v in state)
    if isinstance(state, (np.ndarray, np.generic, bool, int, float)):
        return torch.from_numpy(np.array(state))  # a C-contiguous copy
    return state


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_state(directory: str, step: int, state: Dict[str, Any]) -> None:
    """Save a state dict as ``directory/step_<n>``, atomically."""
    path = _step_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".step_{step}.", suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_arrayify(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _like(saved, template, where: str):
    """``saved`` (CPU tensors in nested containers) in ``template``'s form."""
    if isinstance(template, dict):
        return {k: _like(saved[k], v, f"{where}[{k!r}]") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{where}: saved {len(saved)} items, template has {len(template)}")
        return type(template)(_like(s, t, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved, template)))
    if isinstance(template, torch.Tensor):
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"{where}: saved shape {tuple(saved.shape)}, template "
                             f"{tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    want = np.asarray(template)
    got = saved.cpu().numpy() if isinstance(saved, torch.Tensor) else np.asarray(saved)
    if got.shape != want.shape:
        raise ValueError(f"{where}: saved shape {got.shape}, template {want.shape}")
    return got.astype(want.dtype, copy=False)


def restore_state(
    directory: str, step: Optional[int] = None, template: Optional[Dict] = None
) -> Optional[Dict[str, Any]]:
    """Restore the given (or latest) step; returns None if nothing saved.

    Without a template every leaf comes back as a CPU tensor.  With one (a
    matching nested structure) each leaf takes its template leaf's form: a
    tensor of its dtype and shape on its device, or a numpy array of its
    dtype and shape for a numpy array or scalar."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    devices = {t.device for t in _tensors(template)}
    location = devices.pop() if len(devices) == 1 else torch.device("cpu")
    saved = torch.load(_step_path(directory, step), map_location=location, weights_only=True)
    if template is None:
        return saved
    return _like(saved, template, "state")


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
