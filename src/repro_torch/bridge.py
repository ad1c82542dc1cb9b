"""Parameters across the framework boundary.

The JAX package keeps a model's parameters as a pytree whose leaves are
addressed by ``/``-joined paths (``api/artifact.py`` ``_flatten_params``),
for example ``stack/pos0/mixer/wq``. Leaves under ``stack/pos<p>`` carry a
leading ``n_periods`` axis (one entry per repetition of the block
pattern); ``tail/<j>`` holds the remainder layers unstacked.

The port keeps one dict per layer instead::

    params = {"embed": (V, d), "final_norm": {"scale": (d,)},
              ["lm_head": (d, V),]
              "layers": [{"norm1": .., "mixer": .., "norm2": .., "ffn": ..},
                         ...]}          # n_layers entries, in layer order

Layer ``i * P + p`` is period ``i`` of ``stack/pos<p>`` (P = pattern
length); layer ``n_periods * P + j`` is ``tail/<j>``. Leaf layouts are the
JAX package's (``wq`` is ``(d, Hq, D)``, ``wo`` is ``(Hq, D, d)``), so the
same einsums read them.

bfloat16 crosses as its 16-bit pattern: ``torch.from_numpy`` rejects
numpy's ``bfloat16`` extension dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """``/``-joined path -> numpy leaf (the rule of ``_flatten_params``)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                       # writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _put(tree: Dict[str, Any], parts, leaf) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def _layout(cfg: ModelConfig):
    P = len(cfg.block_pattern)
    return P, cfg.n_layers // P


def to_torch(tree: Dict[str, Any], cfg: ModelConfig,
             device="cpu") -> Dict[str, Any]:
    """JAX param pytree (leaves as numpy or anything ``np.asarray``
    takes) -> the port's per-layer params on ``device``."""
    P, n_p = _layout(cfg)
    params: Dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
    for path, a in flatten(tree).items():
        parts = path.split("/")
        if parts[0] == "stack":
            p = int(parts[1][len("pos"):])
            if a.shape[0] != n_p:
                raise ValueError(f"{path}: leading axis {a.shape[0]} is not "
                                 f"n_periods={n_p}")
            for i in range(n_p):
                _put(params["layers"][i * P + p], parts[2:],
                     _tensor(a[i]).to(device))
        elif parts[0] == "tail":
            _put(params["layers"][n_p * P + int(parts[1])], parts[2:],
                 _tensor(a).to(device))
        else:
            _put(params, parts, _tensor(a).to(device))
    return params


def to_numpy(params: Dict[str, Any], cfg: ModelConfig
             ) -> Dict[str, np.ndarray]:
    """The reverse of :func:`to_torch`, flat: JAX path -> numpy leaf,
    with stacked leaves re-stacked along their ``n_periods`` axis."""
    P, n_p = _layout(cfg)
    out: Dict[str, np.ndarray] = {}
    stacked: Dict[str, list] = {}
    for name, v in params.items():
        if name != "layers":
            out.update(flatten({name: _np_tree(v)}))
    for layer, lp in enumerate(params["layers"]):
        if layer < n_p * P:
            prefix = f"stack/pos{layer % P}"
            for path, a in flatten(_np_tree(lp), prefix).items():
                stacked.setdefault(path, []).append(a)
        else:
            out.update(flatten(_np_tree(lp), f"tail/{layer - n_p * P}"))
    for path, arrs in stacked.items():
        out[path] = np.stack(arrs)
    return out


def leaves(params):
    """Every tensor of the port's params, in order."""
    if isinstance(params, dict):
        for v in params.values():
            yield from leaves(v)
    elif isinstance(params, list):
        for v in params:
            yield from leaves(v)
    else:
        yield params


def params_to(params, device):
    """The port's params with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _np_tree(v):
    if isinstance(v, dict):
        return {k: _np_tree(x) for k, x in v.items()}
    return _array(v)
