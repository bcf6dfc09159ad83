"""CLIP vision tower (ViT-L/14 by default) in PyTorch.

Counterpart of ``facet_tpu/models/clip.py`` (``CLIPVisionTower`` and its
three attention schedules). Parameters stay float32; compute runs in
``dtype`` (bfloat16 on the engine's path, as ``AestheticScorer`` runs it)
with the JAX package's casting points: bf16 pixels into the patch
embedding, LayerNorms in float32 (``ln_pre`` cast back to ``dtype``), q/k/v
and the attention in ``dtype``, and the final projection in float32.

The attention schedule (``FACET_ATTN_IMPL``, ``resolve_attn_impl``) is an
argument of ``forward``, not a module attribute, so one tower serves every
schedule with the same parameters:

- ``xla``: logits of the pre-scaled q in ``dtype``, ``torch.softmax``, P V;
- ``psoftmax``: the same logits through kernel 6 (``ops/softmax.py``);
- ``flash``: unscaled q, k, v through kernel 7 (``ops/flash_attention.py``).
"""

import os
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.ops.flash_attention import flash_attention
from facet_tpu_torch.ops.softmax import softmax

# the row softmax of each materialized-logits schedule; "flash" fuses its own
_SOFTMAX = {"xla": partial(torch.softmax, dim=-1), "psoftmax": softmax}
ATTN_IMPLS = (*_SOFTMAX, "flash")


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    projection_dim: int = 768

    @property
    def grid(self):
        return self.image_size // self.patch_size

    @property
    def seq_len(self):
        return self.grid * self.grid + 1


def clip_vision_config_from(clip_settings):
    """CLIPVisionConfig from the scoring config's models.clip.architecture
    block (absent keys -> ViT-L/14 defaults); mirrors
    facet_tpu.models.checkpoints.clip_vision_config_from."""
    arch = (clip_settings or {}).get("architecture") or {}
    d = CLIPVisionConfig()
    return CLIPVisionConfig(
        image_size=arch.get("image_size", d.image_size),
        patch_size=arch.get("patch_size", d.patch_size),
        width=arch.get("width", d.width),
        layers=arch.get("layers", d.layers),
        heads=arch.get("heads", d.heads),
        projection_dim=arch.get("projection_dim", d.projection_dim),
    )


# CLIP preprocessing constants (open_clip defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def resolve_attn_impl(impl="auto", seq_len=CLIPVisionConfig().seq_len):
    """The ViT's attention schedule: ``FACET_ATTN_IMPL`` when set, else
    ``impl``; "auto" is "xla". Anything but ATTN_IMPLS raises.

    Under "flash", ``FACET_FLASH_BLOCK`` is the TPU kernel's key block. Below
    the padded sequence length (``seq_len`` rounded up to 128) it splits the
    keys into several blocks that the TPU kernel combines by an online
    rescale, with other rounding points; kernel 7 computes only the
    one-block schedule, so those values raise too."""
    impl = os.environ.get("FACET_ATTN_IMPL", impl)
    if impl == "auto":
        impl = "xla"
    if impl not in ATTN_IMPLS:
        raise ValueError(f"FACET_ATTN_IMPL={impl!r} has no counterpart in "
                         f"facet_tpu_torch: the port runs {ATTN_IMPLS}")
    block = os.environ.get("FACET_FLASH_BLOCK")
    padded = -(-seq_len // 128) * 128
    if impl == "flash" and block is not None and int(block) < padded:
        raise ValueError(
            f"FACET_FLASH_BLOCK={block} splits the {padded} padded keys into "
            f"several blocks; facet_tpu_torch computes the one-block schedule only "
            f"(unset it, or set it to {padded} or more)")
    return impl


def check_quant_impl():
    """``FACET_CLIP_INT8`` set truthy selects the JAX package's int8
    projection tier, which is not ported: raise rather than compute exact
    bf16 under that name."""
    env = os.environ.get("FACET_CLIP_INT8")
    if env is not None and env not in ("", "0", "false"):
        raise NotImplementedError(
            f"FACET_CLIP_INT8={env!r}: the int8 projection tier is not ported to "
            f"facet_tpu_torch (ROADMAP Queue 1 #10); unset it")


def _linear(x, layer, dtype):
    """flax Dense(dtype=...): input and params cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Attention(nn.Module):
    def __init__(self, width, heads, dtype):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, attn_impl="xla"):
        b, s, _ = x.shape
        head_dim = self.width // self.heads
        scale = head_dim ** -0.5
        q, k, v = (_linear(x, layer, self.dtype).view(b, s, self.heads, head_dim)
                   for layer in (self.q_proj, self.k_proj, self.v_proj))
        if attn_impl == "flash":
            out = flash_attention(q, k, v, scale)               # (B, S, H, D)
        else:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, D)
            logits = torch.matmul(q * scale, k.transpose(-1, -2))
            weights = _SOFTMAX[attn_impl](logits).to(self.dtype)
            out = torch.matmul(weights, v).transpose(1, 2)
        return _linear(out.reshape(b, s, self.width), self.out_proj, self.dtype)

    def flax_layout(self, path):
        return [leaf for name in ("q_proj", "k_proj", "v_proj", "out_proj")
                for leaf in P.dense(path + (name,), getattr(self, name))]


class MLP(nn.Module):
    def __init__(self, width, hidden, dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        x = F.gelu(_linear(x, self.fc1, self.dtype), approximate="none")
        return _linear(x, self.fc2, self.dtype)

    def flax_layout(self, path):
        return P.dense(path + ("fc1",), self.fc1) + P.dense(path + ("fc2",), self.fc2)


class Block(nn.Module):
    def __init__(self, width, heads, mlp_ratio, dtype):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = Attention(width, heads, dtype)
        self.ln2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width, int(width * mlp_ratio), dtype)

    def forward(self, x, attn_impl="xla"):
        x = x + self.attn(self.ln1(x.float()), attn_impl)
        return x + self.mlp(self.ln2(x.float()))

    def flax_layout(self, path):
        return (P.layer_norm(path + ("ln1",), self.ln1)
                + self.attn.flax_layout(path + ("attn",))
                + P.layer_norm(path + ("ln2",), self.ln2)
                + self.mlp.flax_layout(path + ("mlp",)))


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) CLIP-normalized float32 pixels -> (B, projection_dim) f32."""

    def __init__(self, config=CLIPVisionConfig(), dtype=torch.bfloat16):
        super().__init__()
        self.config, self.dtype = config, dtype
        c = config
        self.patch_embed = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                                     bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c.width))
        self.position_embedding = nn.Parameter(torch.zeros(c.seq_len, c.width))
        self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        self.blocks = nn.ModuleList(Block(c.width, c.heads, c.mlp_ratio, dtype)
                                    for _ in range(c.layers))
        self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        self.projection = nn.Parameter(torch.zeros(c.width, c.projection_dim))

    def forward(self, pixels, attn_impl="xla"):
        dt = self.dtype
        x = F.conv2d(pixels.to(dt).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(dt), stride=self.config.patch_size)
        x = x.flatten(2).transpose(1, 2)                    # (B, grid*grid, width)
        b = x.shape[0]
        cls = self.class_embedding.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)
        x = self.ln_pre(x.float()).to(dt)
        for block in self.blocks:
            x = block(x, attn_impl)
        pooled = self.ln_post(x[:, 0].float())
        return pooled @ self.projection

    def flax_layout(self):
        p = ("params",)
        leaves = (P.conv(p + ("patch_embed",), self.patch_embed)
                  + P.raw(p + ("class_embedding",), self.class_embedding)
                  + P.raw(p + ("position_embedding",), self.position_embedding)
                  + P.layer_norm(p + ("ln_pre",), self.ln_pre)
                  + P.layer_norm(p + ("ln_post",), self.ln_post)
                  + P.raw(p + ("projection",), self.projection))
        for i, block in enumerate(self.blocks):
            leaves += block.flax_layout(p + (f"block_{i}",))
        return leaves


def normalize_pixels(crops):
    """(B, 224, 224, 3) f32 in [0, 255] -> CLIP-normalized f32."""
    mean = torch.as_tensor(CLIP_MEAN, device=crops.device)
    std = torch.as_tensor(CLIP_STD, device=crops.device)
    return (crops / 255.0 - mean) / std
