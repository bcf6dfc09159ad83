"""Qwen2.5-VL vision tower in PyTorch: the VLM tagger's image encoder.

Counterpart of ``facet_tpu/models/qwen_vision.py`` (``QwenVisionTower``,
``QwenVisionEncoder``, ``window_layout``, ``rotary_tables``), in float32
under ``ops/precision.py:full_float32()`` (TF32 off: it would change the
tower's results against the JAX package):

- patch embed: the stride=kernel Conv3d as one matmul over flattened
  (C * T * P * P) patch rows, which arrive in the processor's cell-major
  (spatial_merge_unit) order;
- the grid is padded up to whole windows: pad cells are zeros with a
  validity mask, so every window holds the same token count and the
  windowed blocks run as one batched (n_windows, tokens) attention;
- the full-attention blocks (7, 15, 23, 31 at 7B) run over the whole
  padded sequence with that mask, in query chunks of at most
  ``SCORE_CHUNK_BYTES`` of float32 scores (each query row's softmax is its
  own, so the chunks change no value);
- 2D rope in float32, masked slots at -1e30 before the softmax;
- merger: RMSNorm (eps 1e-6), the 2x2 cells concatenated, Dense,
  ``gelu(approximate=False)``, Dense, then the inverse window permutation
  back to raster order.

The layout (window permutation, validity, rope tables) depends only on
the patch grid and is kept per (grid_h, grid_w) as device tensors.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.ops.precision import full_float32

# the largest float32 score block one attention call materializes at once
SCORE_CHUNK_BYTES = 1 << 30


@dataclass(frozen=True)
class QwenVisionConfig:
    # Qwen2.5-VL-7B vision tower; tests override with tiny dims
    hidden_size: int = 1280
    out_hidden_size: int = 3584
    intermediate_size: int = 3420
    num_heads: int = 16
    depth: int = 32
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple = (7, 15, 23, 31)

    @property
    def patch_dim(self):
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merger_window(self):
        """Window edge in merged-cell units."""
        return self.window_size // self.spatial_merge_size // self.patch_size


def window_layout(config, grid_h, grid_w):
    """Static window bookkeeping for one (grid_h, grid_w) patch grid, padded
    up to whole windows (get_window_index + the spatial_merge_unit
    grouping). -> dict: perm (padded_cells,) source cell per window-ordered
    slot (-1 on pad cells), valid (padded_cells,) bool, inverse
    (real_cells,) window-ordered slot per raster cell, n_windows,
    cells_per_window."""
    m = config.spatial_merge_size
    lh, lw = grid_h // m, grid_w // m
    win = config.merger_window
    pad_h = (-lh) % win
    pad_w = (-lw) % win
    nwh, nww = (lh + pad_h) // win, (lw + pad_w) // win

    index = np.full(((lh + pad_h), (lw + pad_w)), -1, np.int64)
    index[:lh, :lw] = np.arange(lh * lw).reshape(lh, lw)
    index = index.reshape(nwh, win, nww, win).transpose(0, 2, 1, 3)
    perm = index.reshape(-1)
    valid = perm >= 0
    inverse = np.empty(lh * lw, np.int64)
    inverse[perm[valid]] = np.nonzero(valid)[0]
    return {"perm": perm, "valid": valid, "inverse": inverse,
            "n_windows": nwh * nww, "cells_per_window": win * win}


def rotary_tables(config, grid_h, grid_w):
    """(seq, head_dim) float32 cos/sin tables in the processor's cell-major
    patch order (rot_pos_emb with its duplicated halves), before the window
    permutation."""
    m = config.spatial_merge_size
    head_dim = config.hidden_size // config.num_heads
    dim = head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))

    hpos = np.arange(grid_h)[:, None].repeat(grid_w, 1)
    wpos = np.arange(grid_w)[None, :].repeat(grid_h, 0)

    def order(a):
        return a.reshape(grid_h // m, m, grid_w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = order(hpos), order(wpos)
    emb = np.concatenate([hpos[:, None] * inv_freq[None, :],
                          wpos[:, None] * inv_freq[None, :]], axis=1)
    emb = np.concatenate([emb, emb], axis=1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class RMSNorm(nn.Module):
    """The tower's RMSNorm: float32 variance, scale applied after rounding
    back to the input's dtype."""

    def __init__(self, dim, device, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = P.frozen(dim, device=device)

    def forward(self, x):
        var = x.to(torch.float32).square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale

    def flax_layout(self, path):
        return P.raw(path + ("scale",), self.scale)


def attend(q, k, v, valid, scale):
    """Masked softmax attention: q/k/v (G, T, H, D), valid (G, T) bool of
    the attendable keys -> (G, T, H, D). Query rows are taken in chunks of
    at most SCORE_CHUNK_BYTES of float32 scores."""
    g, t, h, _ = q.shape
    rows = max(1, SCORE_CHUNK_BYTES // (4 * g * h * t))
    keep = valid[:, None, None, :]
    out = []
    for start in range(0, t, rows):
        scores = torch.einsum("gqhd,gkhd->ghqk", q[:, start:start + rows], k) / scale
        weights = torch.softmax(scores.masked_fill(~keep, -1e30), dim=-1)
        out.append(torch.einsum("ghqk,gkhd->gqhd", weights, v))
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]


class VisionBlock(nn.Module):
    def __init__(self, config, device):
        super().__init__()
        e, i = config.hidden_size, config.intermediate_size
        self.heads = config.num_heads
        self.norm1 = RMSNorm(e, device)
        self.norm2 = RMSNorm(e, device)
        self.qkv_weight = P.frozen(3 * e, e, device=device)
        self.qkv_bias = P.frozen(3 * e, device=device)
        self.proj_weight = P.frozen(e, e, device=device)
        self.proj_bias = P.frozen(e, device=device)
        self.gate_up_weight = P.frozen(2 * i, e, device=device)
        self.gate_up_bias = P.frozen(2 * i, device=device)
        self.down_weight = P.frozen(e, i, device=device)
        self.down_bias = P.frozen(e, device=device)

    def attention(self, x, cos, sin, valid):
        """x: (G, T, E); cos/sin: (G, T, head_dim); valid: (G, T) bool."""
        g, t, e = x.shape
        hd = e // self.heads
        qkv = F.linear(x, self.qkv_weight, self.qkv_bias).view(g, t, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
        q = q * c + _rotate_half(q) * s
        k = k * c + _rotate_half(k) * s
        out = attend(q, k, v, valid, np.float32(np.sqrt(hd)).item())
        return F.linear(out.reshape(g, t, e), self.proj_weight, self.proj_bias)

    def forward(self, x, cos, sin, valid):
        x = x + self.attention(self.norm1(x), cos, sin, valid)
        gate, up = F.linear(self.norm2(x), self.gate_up_weight, self.gate_up_bias).chunk(2, -1)
        return x + F.linear(F.silu(gate) * up, self.down_weight, self.down_bias)

    def flax_layout(self, path):
        i = self.down_weight.shape[1]
        return (self.norm1.flax_layout(path + ("norm1",))
                + self.norm2.flax_layout(path + ("norm2",))
                + P.kernel(path + ("attn", "qkv"), self.qkv_weight, self.qkv_bias)
                + P.kernel(path + ("attn", "proj"), self.proj_weight, self.proj_bias)
                + P.kernel(path + ("gate_proj",), self.gate_up_weight[:i],
                           self.gate_up_bias[:i])
                + P.kernel(path + ("up_proj",), self.gate_up_weight[i:],
                           self.gate_up_bias[i:])
                + P.kernel(path + ("down_proj",), self.down_weight, self.down_bias))


class QwenVisionTower(nn.Module):
    """One image per call: (seq, patch_dim) float32 patch rows of a
    (grid_h, grid_w) grid -> (seq / merge^2, out_hidden_size) merged
    embeddings in raster order."""

    def __init__(self, config=QwenVisionConfig(), device=None):
        super().__init__()
        self.config = config
        e = config.hidden_size
        unit = config.spatial_merge_size ** 2
        self.patch_embed = P.frozen(e, config.patch_dim, device=device)
        self.blocks = nn.ModuleList(VisionBlock(config, device) for _ in range(config.depth))
        self.ln_q = RMSNorm(e, device)
        self.fc1_weight = P.frozen(unit * e, unit * e, device=device)
        self.fc1_bias = P.frozen(unit * e, device=device)
        self.fc2_weight = P.frozen(config.out_hidden_size, unit * e, device=device)
        self.fc2_bias = P.frozen(config.out_hidden_size, device=device)
        self._layouts = {}

    @property
    def device(self):
        return self.patch_embed.device

    def layout(self, grid_h, grid_w):
        """-> (gather, valid, inverse, cos, sin, n_windows) for the grid, on
        the device: window-ordered cell gather (pad cells read cell 0 and
        are zeroed), cell validity, the inverse permutation, and the rope
        tables already permuted into window order."""
        key = (grid_h, grid_w)
        if key not in self._layouts:
            lay = window_layout(self.config, grid_h, grid_w)
            cos, sin = rotary_tables(self.config, grid_h, grid_w)
            dev = self.device
            gather = torch.as_tensor(np.where(lay["perm"] >= 0, lay["perm"], 0), device=dev)
            valid = torch.as_tensor(lay["valid"], device=dev)
            tables = [self._permute(torch.as_tensor(a, device=dev), gather, valid)
                      for a in (cos, sin)]
            self._layouts[key] = (gather, valid, torch.as_tensor(lay["inverse"], device=dev),
                                  *tables, lay["n_windows"])
        return self._layouts[key]

    def _permute(self, arr, gather, valid):
        """(cells * unit, D) in cell-major order -> (padded_cells * unit, D)
        in window order, pad cells zero."""
        unit = self.config.spatial_merge_size ** 2
        grouped = arr.reshape(-1, unit, arr.shape[-1])[gather]
        grouped = grouped * valid.to(arr.dtype)[:, None, None]
        return grouped.reshape(-1, arr.shape[-1])

    def forward(self, patches, grid_h, grid_w):
        cfg = self.config
        unit = cfg.spatial_merge_size ** 2
        gather, valid, inverse, cos, sin, nwin = self.layout(grid_h, grid_w)
        x = self._permute(F.linear(patches.to(torch.float32), self.patch_embed), gather, valid)
        token_valid = valid.repeat_interleave(unit)
        per_window = (nwin, -1)
        for i, block in enumerate(self.blocks):
            if i in cfg.fullatt_block_indexes:
                x = block(x[None], cos[None], sin[None], token_valid[None])[0]
            else:
                x = block(x.view(*per_window, x.shape[-1]), cos.view(*per_window, cos.shape[-1]),
                          sin.view(*per_window, sin.shape[-1]),
                          token_valid.view(per_window)).reshape(x.shape)
        return self.merger(x)[inverse]

    def merger(self, x):
        """(cells * unit, E) tokens in cell-major order -> (cells, out_hidden):
        RMSNorm, the unit's cells concatenated, Dense, exact gelu, Dense."""
        unit = self.config.spatial_merge_size ** 2
        y = self.ln_q(x).reshape(-1, unit * self.config.hidden_size)
        y = F.gelu(F.linear(y, self.fc1_weight, self.fc1_bias), approximate="none")
        return F.linear(y, self.fc2_weight, self.fc2_bias)

    def flax_layout(self):
        leaves = P.kernel(("params", "patch_embed"), self.patch_embed)
        for i, block in enumerate(self.blocks):
            leaves += block.flax_layout(("params", f"block{i}"))
        return (leaves + self.ln_q.flax_layout(("params", "ln_q"))
                + P.kernel(("params", "merger_fc1"), self.fc1_weight, self.fc1_bias)
                + P.kernel(("params", "merger_fc2"), self.fc2_weight, self.fc2_bias))


class QwenVisionEncoder:
    """Encodes the processor's patch rows on the tower's device: one tower
    call per image, in full float32."""

    def __init__(self, tower):
        self.tower = tower
        self.config = tower.config

    @classmethod
    def load(cls, device, config=None):
        """The converted tower (pretrained_models/qwen25_vision.npz) on
        ``device``, or None when it is not installed."""
        tree = P.load_npz("qwen25_vision")
        if tree is None:
            return None
        return cls(P.bridge(QwenVisionTower(config or QwenVisionConfig(), device), tree))

    @torch.no_grad()
    def encode(self, patches, grid_thw):
        """patches (total_seq, patch_dim) float; grid_thw [(t, h, w)] ->
        (total_merged_cells, out_hidden) float32 on the device, image order
        kept."""
        patches = torch.as_tensor(np.asarray(patches, np.float32), device=self.tower.device)
        outs, offset = [], 0
        with full_float32():
            for t, h, w in grid_thw:
                seq = int(t) * int(h) * int(w)
                outs.append(self.tower(patches[offset:offset + seq], int(h), int(w)))
                offset += seq
        return torch.cat(outs)

