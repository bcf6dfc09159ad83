"""Parameters: flax-layout tables, the numpy fallback init, npz loading and
the flax -> torch bridge.

Every port module that holds parameters exposes ``flax_layout()``: a list of
``Leaf`` entries naming each flax leaf (its path in the flax variables tree
and its flax shape), the torch tensor it fills and how the layout converts.
From that one table:

- ``fallback_init(module, seed)`` reproduces
  ``facet_tpu.models.checkpoints.fallback_init`` bit for bit without jax:
  leaves in ``jax.tree_util`` flatten order (sorted keys at every level, so
  ``batch_stats`` before ``params``), the uint32 hash
  ``arange(n) * 2654435761 + ((0x9E3779B9 * (i + 1) + seed) & 0xFFFFFFFF)``,
  ``u = (x >> 8) * 2**-24`` and ``(u - 0.5) * 2 / sqrt(fan_in)`` in float32
  for >=2-D leaves; ones for 1-D ``scale``/``var``/``running_var`` leaves,
  zeros otherwise.
- ``bridge(module, flax_tree)`` copies a flax tree (nested dicts of arrays)
  onto the module and raises on any uncovered or surplus key.
- ``load_npz(name)`` reads ``pretrained_models/<name>.npz`` in the flattened
  ``a/b/c`` layout of ``facet_tpu.models.convert.save_params``.

Seeds follow the JAX package: CLIP vision 0, aesthetic head 1
(``checkpoints.load_clip_vision_params``), TOPIQ 30. ``TOPIQScorer.create``
in the JAX package initializes TOPIQ with ``jax.random`` instead, which has
no jax-free reproduction; the port uses ``fallback_init(seed=30)`` (as
``bench.py`` builds TOPIQ), so the two packages' uninitialized TOPIQ scores
differ unless both are given the same tree.
"""

import math
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

PRETRAINED_DIR = os.environ.get("FACET_PRETRAINED_DIR", "pretrained_models")


@dataclass
class Leaf:
    path: tuple            # flax path, e.g. ("params", "block_0", "ln1", "scale")
    shape: tuple           # flax shape
    tensor: torch.Tensor   # the torch parameter / buffer it fills
    convert: Callable      # numpy flax array -> numpy array in torch layout


def _same(a):
    return a


def _dense_kernel(a):          # (in, out) -> (out, in)
    return a.T


def _conv_kernel(a):           # HWIO -> OIHW
    return a.transpose(3, 2, 0, 1)


def _dg_in_kernel(a):          # (in, H, D) -> (H*D, in)
    return a.reshape(a.shape[0], -1).T


def _dg_out_kernel(a):         # (H, D, out) -> (out, H*D)
    return a.reshape(-1, a.shape[-1]).T


def _flat(a):
    return a.reshape(-1)


# ------------------------------------------------------- layout builders


def dense(path, linear):
    out, inp = linear.weight.shape
    leaves = [Leaf(path + ("kernel",), (inp, out), linear.weight, _dense_kernel)]
    if linear.bias is not None:
        leaves.append(Leaf(path + ("bias",), (out,), linear.bias, _same))
    return leaves


def dense_general_in(path, linear, heads):
    """flax DenseGeneral(features=(heads, dim)) onto an nn.Linear(in, heads*dim)."""
    out, inp = linear.weight.shape
    dim = out // heads
    return [Leaf(path + ("kernel",), (inp, heads, dim), linear.weight, _dg_in_kernel),
            Leaf(path + ("bias",), (heads, dim), linear.bias, _flat)]


def dense_general_out(path, linear, heads):
    """flax DenseGeneral(axis=(-2, -1)) onto an nn.Linear(heads*dim, out)."""
    out, inp = linear.weight.shape
    dim = inp // heads
    return [Leaf(path + ("kernel",), (heads, dim, out), linear.weight, _dg_out_kernel),
            Leaf(path + ("bias",), (out,), linear.bias, _same)]


def conv(path, conv2d):
    o, i, kh, kw = conv2d.weight.shape
    leaves = [Leaf(path + ("kernel",), (kh, kw, i, o), conv2d.weight, _conv_kernel)]
    if conv2d.bias is not None:
        leaves.append(Leaf(path + ("bias",), (o,), conv2d.bias, _same))
    return leaves


def layer_norm(path, ln):
    return [Leaf(path + ("scale",), tuple(ln.weight.shape), ln.weight, _same),
            Leaf(path + ("bias",), tuple(ln.bias.shape), ln.bias, _same)]


def batch_norm(path, bn):
    """``path`` is the module path below the collection name."""
    c = (bn.num_features,)
    return [Leaf(("params",) + path + ("scale",), c, bn.weight, _same),
            Leaf(("params",) + path + ("bias",), c, bn.bias, _same),
            Leaf(("batch_stats",) + path + ("mean",), c, bn.running_mean, _same),
            Leaf(("batch_stats",) + path + ("var",), c, bn.running_var, _same)]


def raw(path, tensor):
    return [Leaf(path, tuple(tensor.shape), tensor, _same)]


# ------------------------------------------------------------ fallback init


def fallback_values(leaves, seed=0):
    """-> {flax path: float32 numpy array}, bit-identical to
    facet_tpu.models.checkpoints.fallback_init over the same flax tree."""
    out = {}
    ordered = sorted(leaves, key=lambda leaf: leaf.path)
    for i, leaf in enumerate(ordered):
        shape = leaf.shape
        if len(shape) >= 2:
            n = int(np.prod(shape))
            fan_in = int(np.prod(shape[:-1]))
            scale = 1.0 / math.sqrt(max(1, fan_in))
            offset = np.uint32((0x9E3779B9 * (i + 1) + seed) & 0xFFFFFFFF)
            with np.errstate(over="ignore"):
                x = np.arange(n, dtype=np.uint32) * np.uint32(2654435761) + offset
            u = (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
            val = (u - np.float32(0.5)) * np.float32(2.0 * scale)
            out[leaf.path] = val.reshape(shape)
        elif leaf.path[-1] in ("scale", "var", "running_var"):
            out[leaf.path] = np.ones(shape, np.float32)
        else:
            out[leaf.path] = np.zeros(shape, np.float32)
    return out


def _assign(leaves, values):
    with torch.no_grad():
        for leaf in leaves:
            # np.array, not np.ascontiguousarray, which makes a 0-d leaf 1-d
            arr = np.array(leaf.convert(np.asarray(values[leaf.path], np.float32)),
                           order="C")
            if tuple(arr.shape) != tuple(leaf.tensor.shape):
                raise ValueError(f"{'/'.join(leaf.path)}: flax shape "
                                 f"{values[leaf.path].shape} does not map onto "
                                 f"torch shape {tuple(leaf.tensor.shape)}")
            leaf.tensor.copy_(torch.tensor(arr, dtype=leaf.tensor.dtype))


def fallback_init(module, seed=0):
    """Fill ``module`` with the JAX package's deterministic fallback params."""
    leaves = module.flax_layout()
    _assign(leaves, fallback_values(leaves, seed))
    return module


# ------------------------------------------------------------------ bridge


def flatten_tree(tree, prefix=()):
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            flat.update(flatten_tree(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def bridge(module, flax_tree):
    """Copy a flax variables tree onto ``module``; raises on any flax key the
    module does not cover and on any module leaf the tree does not hold."""
    leaves = module.flax_layout()
    flat = flatten_tree(flax_tree)
    want = {leaf.path for leaf in leaves}
    missing = sorted(want - set(flat))
    surplus = sorted(set(flat) - want)
    if missing or surplus:
        raise KeyError(
            f"flax tree does not match {type(module).__name__}: "
            f"missing {['/'.join(p) for p in missing][:8]}, "
            f"surplus {['/'.join(p) for p in surplus][:8]}")
    _assign(leaves, flat)
    return module


def load_npz(name):
    """-> flax variables tree from ``pretrained_models/<name>.npz``, or None."""
    path = os.path.join(PRETRAINED_DIR, f"{name}.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    tree = {}
    for key in data.files:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]
    return tree


def init_or_load(module, name, seed):
    """Converted checkpoint when one is installed, else the fallback init."""
    tree = load_npz(name)
    if tree is None:
        return fallback_init(module, seed)
    # converter trees carry a 'meta' branch (e.g. the aesthetic head's
    # normalize_input flag) that holds no parameter
    tree = {k: v for k, v in tree.items() if k != "meta"}
    return bridge(module, tree)
