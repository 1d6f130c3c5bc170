"""Checkpointing: flat-key npz save/restore for params + optimizer state.

PyTorch port of ``repro.training.checkpoint``, with the reference's keys,
so an archive written by either package restores in the other:
``params::<path>`` for each parameter (dict keys joined by ``::``),
``opt::.step``, ``opt::.mu::<path>`` and ``opt::.nu::<path>`` for the
optimizer state (``jax.tree_util`` prints a NamedTuple field as
``.name``), and ``__step__``.  A bf16 tensor is stored as the reference's
numpy writes one: two raw bytes an element (numpy dtype ``V2``), which
``restore`` reads back into a bf16 template bitwise (the reference itself
cannot restore a bf16 archive without ``ml_dtypes``).  Writes are atomic:
the archive is written to ``path + ".tmp"`` and renamed.  ``restore``
builds new trees from templates; ``restore_into`` writes into given ones.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import OptState

_SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, OptState):
        out: Dict[str, torch.Tensor] = {}
        for name in OptState._fields:
            out.update(_flatten(getattr(tree, name), _join(prefix, "." + name)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], _join(prefix, str(k))))
        return out
    return {prefix: tree}


def _join(prefix: str, key: str) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else key


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bytes
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    if isinstance(template, OptState):
        return OptState(*(_unflatten_into(getattr(template, name), flat,
                                          _join(prefix, "." + name))
                          for name in OptState._fields))
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, _join(prefix, str(k)))
                for k in sorted(template)}
    arr = flat[prefix]
    assert arr.shape == tuple(template.shape), (prefix, arr.shape, template.shape)
    return _from_numpy(arr, template)


def save(path: str, params: Any, opt_state: Any = None, step: int = 0) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {_join("params", k): _to_numpy(v) for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({_join("opt", k): _to_numpy(v)
                        for k, v in _flatten(opt_state).items()})
    payload["__step__"] = np.int64(step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def restore(path: str, params_template: Any,
            opt_template: Any = None) -> Tuple[Any, Any, int]:
    """``(params, opt_state, step)`` from ``path``, each leaf in its
    template's dtype and on its device (``opt_state`` None without an
    ``opt_template``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", 0))
    params = _unflatten_into(params_template, _strip(flat, "params"))
    opt_state = None
    if opt_template is not None:
        opt_state = _unflatten_into(opt_template, _strip(flat, "opt"))
    return params, opt_state, step


def restore_into(path: str, params: Any, opt_state: Any = None) -> int:
    """Restore ``path`` into the tensors of ``params`` (and ``opt_state``)
    in place, each leaf cast to its own dtype and device, as ``restore``
    would build them; returns the archive's step.  A training program's
    held trees keep their addresses (``training.train.TrainProgram``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__", 0))
    trees = [(params, _strip(flat, "params"))]
    if opt_state is not None:
        trees.append((opt_state, _strip(flat, "opt")))
    for tree, arrays in trees:
        for key, t in _flatten(tree).items():
            arr = arrays[key]
            assert arr.shape == tuple(t.shape), (key, arr.shape, t.shape)
            t.copy_(_from_numpy(arr, t))
    return step


def _strip(flat: Dict[str, np.ndarray], head: str) -> Dict[str, np.ndarray]:
    lead = head + _SEP
    return {k[len(lead):]: v for k, v in flat.items() if k.startswith(lead)}
