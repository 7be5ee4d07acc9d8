"""Numerical-debug facilities.

Counterpart of ``feature_detector_fast_tpu.utils.debug``: a NaN tripwire
for a scope of torch calls, finiteness assertions over nested state,
collective-determinism assertions for the multi-device paths (every
replica of a reduced value must be identical: a desync is the
multi-device form of a data race), and the hex printer for mask, score
and packed-word planes.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch
from torch.overrides import TorchFunctionMode, resolve_name


def _has_nan(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.layout == torch.strided
            and (x.is_floating_point() or x.is_complex()) and bool(torch.isnan(x).any()))


class _NanCheck(TorchFunctionMode):
    """Raise FloatingPointError where a torch call's floating output holds
    a NaN.  Inside ``__torch_function__`` the mode is off, so the check's
    own torch calls do not re-enter it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if out is None and args:  # in place with no result (__setitem__)
            outs = (args[0],)
        if any(_has_nan(o) for o in outs):
            name = resolve_name(func) or getattr(func, "__name__", repr(func))
            raise FloatingPointError(f"NaN in the output of {name}")
        return out


@contextlib.contextmanager
def nan_checking() -> Iterator[None]:
    """Trip on NaN in a scope, as ``jax_debug_nans`` does: any torch call
    inside whose floating output holds a NaN raises FloatingPointError
    naming the call (Inf passes, as in JAX).  Each call's check reads its
    output back to the host, so this is a debugging tool, not a mode to run
    in."""
    with _NanCheck():
        yield


def _leaves(tree, path: str = ""):
    """(path, leaf) in ``jax.tree_util.tree_flatten_with_path`` order and
    ``keystr`` form: dict keys sorted as ``[key]``, sequence items as
    ``[i]``, NamedTuple fields as ``.name``; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite(tree, name: str = "value") -> None:
    """Host-side finiteness assertion over nested dicts, lists, tuples and
    NamedTuples of tensors or arrays."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all()
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def assert_replicas_identical(per_device, atol: float = 0.0,
                              name: str = "collective output") -> None:
    """Assert that per-replica values are identical (or within atol) across
    devices: an (n_devices, ...) stack, or a list of per-device tensors
    that may sit on different devices -- the determinism check distributed
    tests run on collective results."""
    replicas = [_host(x) for x in per_device]
    ref = replicas[0]
    for i, other in enumerate(replicas[1:], 1):
        if atol == 0.0:
            if not np.array_equal(ref, other):
                raise AssertionError(
                    f"{name}: replica {i} differs bit-wise from replica 0"
                )
        else:
            np.testing.assert_allclose(
                other, ref, atol=atol,
                err_msg=f"{name}: replica {i} deviates from replica 0")


def dump_plane_hex(plane, max_rows: int = 8, max_cols: int = 32) -> str:
    """Hex-dump the corner of a 2-D integer plane (tensor or array).
    Column width adapts to the plane's value range: byte planes print 2
    digits a value, i32 mask/score/packed-word planes 8, so rows stay
    visually comparable."""
    plane = _host(plane)
    vals = plane[:max_rows, :max_cols].astype(np.int64) & 0xFFFFFFFF
    width = 2 if (vals.size == 0 or vals.max() <= 0xFF) else 8
    rows = []
    for r in vals:
        rows.append(" ".join(f"{int(v):0{width}x}" for v in r))
    return "\n".join(rows)
