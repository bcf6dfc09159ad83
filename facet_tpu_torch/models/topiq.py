"""TOPIQ no-reference image quality model (CFANet-style) in PyTorch.

Counterpart of ``facet_tpu/models/topiq.py``: ResNet50 stages C2..C5 with
inference BatchNorm, 1x1 projections to a common width, coarse-to-fine
cross-attention blocks, attention pooling, an MLP head and a sigmoid.
Engine scores rescale to 0-10. Activations enter NHWC, as in the JAX
package, and run NCHW inside the backbone.

The finest level's attention (C2: 9216 queries over 2304 keys at 384 px,
4096 over 1024 at the fast tier's 256 px) is exactly the set of levels the
JAX package's gate ``supported_shape`` admits; those go through kernel 2
(``ops/attention.py``). The other levels run plain float32 attention, the
counterpart of ``ChunkedAttention``'s xla branch (no query chunking is
needed in eager PyTorch).

flax defaults carried over: LayerNorm epsilon 1e-6, tanh-approximated GELU,
BatchNorm epsilon 1e-5; the stem's -inf padded 3x3/2 max pool equals
``F.max_pool2d(3, 2, padding=1)``.
"""

import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.ops import attention
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.resize import resample_matrix
from facet_tpu_torch.processing.device_pipeline import rider_slice_size

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
FAST_TIER_INPUT_SIZE = 256
LN_EPS = 1e-6     # flax nn.LayerNorm default


@dataclass(frozen=True)
class TOPIQConfig:
    width: int = 256
    heads: int = 4
    input_size: int = 384


class Bottleneck(nn.Module):
    def __init__(self, in_ch, features, stride=1):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn0 = nn.BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features * 4)
        self.down = stride != 1 or in_ch != features * 4
        if self.down:
            self.down_conv = nn.Conv2d(in_ch, features * 4, 1, stride=stride,
                                       bias=False)
            self.down_bn = nn.BatchNorm2d(features * 4)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = []
        for i in range(3):
            leaves += P.conv(p + (f"Conv_{i}",), getattr(self, f"conv{i}"))
            leaves += P.batch_norm(path + (f"BatchNorm_{i}",), getattr(self, f"bn{i}"))
        if self.down:
            leaves += P.conv(p + ("down_conv",), self.down_conv)
            leaves += P.batch_norm(path + ("down_bn",), self.down_bn)
        return leaves


class ResNet50Stages(nn.Module):
    """NCHW input -> feature maps C2 (s4, 256) .. C5 (s32, 2048)."""

    STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = nn.BatchNorm2d(64)
        self.names = []
        in_ch = 64
        for stage, (feats, blocks, stride) in enumerate(self.STAGES):
            for i in range(blocks):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, Bottleneck(in_ch, feats, stride if i == 0 else 1))
                self.names.append(name)
                in_ch = feats * 4

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        stages = []
        for stage, (_, blocks, _) in enumerate(self.STAGES):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x)
            stages.append(x)
        return stages

    def flax_layout(self, path):
        leaves = (P.conv(("params",) + path + ("Conv_0",), self.conv0)
                  + P.batch_norm(path + ("BatchNorm_0",), self.bn0))
        for name in self.names:
            leaves += getattr(self, name).flax_layout(path + (name,))
        return leaves


class ChunkedAttention(nn.Module):
    """Multi-head attention with DenseGeneral q/k/v/out projections."""

    def __init__(self, heads, width):
        super().__init__()
        self.heads, self.width = heads, width
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def forward(self, q_in, kv_in):
        head_dim = self.width // self.heads

        def split(t):                       # (B, N, H*D) -> (B, H, N, D)
            b, n, _ = t.shape
            return t.view(b, n, self.heads, head_dim).transpose(1, 2).contiguous()

        q = split(self.query(q_in) / math.sqrt(head_dim))
        k = split(self.key(kv_in))
        v = split(self.value(kv_in))
        if attention.supported_shape(q.shape[2], k.shape[2]):
            out = attention.cross_attention(q, k, v)
        else:
            p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
            out = torch.matmul(p, v)
        b, _, nq, _ = out.shape
        return self.out(out.transpose(1, 2).reshape(b, nq, self.width))

    def flax_layout(self, path):
        return (P.dense_general_in(path + ("query",), self.query, self.heads)
                + P.dense_general_in(path + ("key",), self.key, self.heads)
                + P.dense_general_in(path + ("value",), self.value, self.heads)
                + P.dense_general_out(path + ("out",), self.out, self.heads))


class CrossAttentionBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_q = nn.LayerNorm(width, eps=LN_EPS)
        self.ln_kv = nn.LayerNorm(width, eps=LN_EPS)
        self.cross = ChunkedAttention(heads, width)
        self.ln_mlp = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = nn.Linear(width, width * 2)
        self.fc2 = nn.Linear(width * 2, width)

    def forward(self, queries, context):
        x = queries + self.cross(self.ln_q(queries), self.ln_kv(context))
        y = self.fc2(F.gelu(self.fc1(self.ln_mlp(x)), approximate="tanh"))
        return x + y

    def flax_layout(self, path):
        p = ("params",) + path
        return (P.layer_norm(p + ("LayerNorm_0",), self.ln_q)
                + P.layer_norm(p + ("LayerNorm_1",), self.ln_kv)
                + self.cross.flax_layout(p + ("cross",))
                + P.layer_norm(p + ("LayerNorm_2",), self.ln_mlp)
                + P.dense(p + ("Dense_0",), self.fc1)
                + P.dense(p + ("Dense_1",), self.fc2))


class TOPIQNet(nn.Module):
    """(B, H, W, 3) ImageNet-normalized f32 -> (B,) quality in [0, 1]."""

    def __init__(self, config=TOPIQConfig()):
        super().__init__()
        self.config = config
        w = config.width
        self.backbone = ResNet50Stages()
        self.proj = nn.ModuleList(nn.Conv2d(c, w, 1) for c in (256, 512, 1024, 2048))
        self.self_top = CrossAttentionBlock(w, config.heads)
        self.cross = nn.ModuleList(CrossAttentionBlock(w, config.heads) for _ in range(3))
        self.pool_norm = nn.LayerNorm(w, eps=LN_EPS)
        self.pool_gate = nn.Linear(w, 1)
        self.head_norm = nn.LayerNorm(w, eps=LN_EPS)
        self.head0 = nn.Linear(w, w)
        self.head1 = nn.Linear(w, 1)

    def forward(self, x):
        stages = self.backbone(x.permute(0, 3, 1, 2))
        tokens = [proj(feat).flatten(2).transpose(1, 2)       # (B, h*w, width)
                  for proj, feat in zip(self.proj, stages)]
        fused = self.self_top(tokens[-1], tokens[-1])
        for level in range(len(tokens) - 2, -1, -1):
            fused = self.cross[level](tokens[level], fused)
        weights = torch.softmax(self.pool_gate(self.pool_norm(fused)), dim=1)
        pooled = torch.sum(fused * weights, dim=1)
        h = F.gelu(self.head0(self.head_norm(pooled)), approximate="tanh")
        return torch.sigmoid(self.head1(h)[:, 0])

    def flax_layout(self):
        p = ("params",)
        leaves = self.backbone.flax_layout(("backbone",))
        for i, proj in enumerate(self.proj):
            leaves += P.conv(p + (f"proj{i}",), proj)
        leaves += self.self_top.flax_layout(("self_top",))
        for level, block in enumerate(self.cross):
            leaves += block.flax_layout((f"cross{level}",))
        return (leaves + P.layer_norm(p + ("pool_norm",), self.pool_norm)
                + P.dense(p + ("pool_gate",), self.pool_gate)
                + P.layer_norm(p + ("head_norm",), self.head_norm)
                + P.dense(p + ("head0",), self.head0)
                + P.dense(p + ("head1",), self.head1))


# Activation bytes of one image per pixel of TOPIQ's input (ResNet50 and the
# attention levels outside kernel 2, in f32), for the rider's slice size
# (processing/device_pipeline.py:rider_slice_size): 357 measured at 384 px
# on an H100 80GB HBM3 at 700 W (chip_smoke.py --probe), rounded up to a
# power of two.
ACT_BYTES_PER_INPUT_PIXEL = 512


class TOPIQScorer:
    """Engine-facing wrapper: uint8 images -> 0-10 quality scores."""

    score_range = (0.0, 1.0)

    def __init__(self, net, device):
        self.net = net.to(device).eval()
        self.config = net.config
        self.device = torch.device(device)
        self._matrices = {}

    @classmethod
    def create(cls, config, cached, device):
        """Host cache > converted checkpoint > fallback init (seed 30); the
        fast speed tier evaluates at 256 px with the same parameters."""
        tcfg = TOPIQConfig()
        if config is not None and config.speed_tier() == "fast":
            tcfg = replace(tcfg, input_size=FAST_TIER_INPUT_SIZE)
        net = TOPIQNet(tcfg)
        if cached is not None:
            net.load_state_dict(cached["params"])
        else:
            P.init_or_load(net, "topiq", seed=30)
        return cls(net, device)

    def host_params(self):
        return {"params": {k: v.detach().cpu() for k, v in self.net.state_dict().items()}}

    def _resize_matrices(self, h, w):
        if (h, w) not in self._matrices:
            size = self.config.input_size
            self._matrices[(h, w)] = (
                torch.from_numpy(resample_matrix(h, size, method="linear")).to(self.device),
                torch.from_numpy(resample_matrix(w, size, method="linear")).to(self.device))
        return self._matrices[(h, w)]

    @torch.no_grad()
    def forward_u8(self, batch_u8):
        """(B, H, W, 3) uint8 on the device -> (B,) raw sigmoid, un-fetched.
        Full float32 (no TF32 in cuDNN or cuBLAS), as the JAX package runs it."""
        rows, cols = self._resize_matrices(*batch_u8.shape[1:3])
        with full_float32():
            x = batch_u8.to(torch.float32)
            x = torch.einsum("rh,bhwc->brwc", rows, x)
            x = torch.einsum("sw,brwc->brsc", cols, x) / 255.0
            mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
            std = torch.as_tensor(IMAGENET_STD, device=x.device)
            return self.net((x - mean) / std)

    def _postprocess(self, raw):
        lo, hi = self.score_range
        return [round(float(np.clip((r - lo) / (hi - lo), 0, 1) * 10.0), 2)
                for r in raw]

    def rider(self, h, w):
        """(run, finish) for joint dispatch on a resident device batch: `run`
        launches the forward slice by slice on the device tensor and returns
        un-fetched outputs; `finish` takes the fetched outputs and the image
        count and yields the 0-10 scores."""
        cap = rider_slice_size(self.device, h, w, self.config.input_size,
                               ACT_BYTES_PER_INPUT_PIXEL)

        def run(dev):
            return [self.forward_u8(dev[i:i + cap]) for i in range(0, dev.shape[0], cap)]

        def finish(fetched, n):
            return self._postprocess(np.concatenate([np.asarray(o) for o in fetched])[:n])

        return run, finish

    def score_batch(self, images):
        """RGB uint8 arrays -> list of 0-10 scores."""
        if not images:
            return []
        raw = np.empty(len(images), np.float32)
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape[:2], []).append(i)
        for (h, w), idxs in by_shape.items():
            run, _ = self.rider(h, w)
            batch = torch.from_numpy(np.stack([images[i] for i in idxs])).to(self.device)
            raw[idxs] = torch.cat(run(batch)).cpu().numpy()
        return self._postprocess(raw)
