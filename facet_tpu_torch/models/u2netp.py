"""U2-Net-P saliency network in PyTorch.

Counterpart of ``facet_tpu/models/u2netp.py``: six RSU encoder stages, five
decoder stages and six side outputs fused by a 1x1 conv, mid width 16 and
stage width 64, inference BatchNorm. It feeds SAMP-Net's saliency input
(``models/samp_net.py``).

Input and output are NHWC, as in the JAX package; the network runs NCHW
inside. ``_down`` is the 2x2 max pool in ceil mode (the JAX package pads
odd sides with -inf); ``_up_to`` is bilinear with half-pixel centres
(``align_corners=False``), which equals ``jax.image.resize(..., "bilinear")``
here because the network only ever upsamples with it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P


class ConvBNRelu(nn.Module):
    def __init__(self, in_ch, features, dilation=1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, padding=dilation, dilation=dilation)
        self.bn = nn.BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def flax_layout(self, path):
        return (P.conv(("params",) + path + ("Conv_0",), self.conv)
                + P.batch_norm(path + ("BatchNorm_0",), self.bn))


def _down(x):
    """2x2 max pool, ceil mode (an odd side's last row or column pools alone)."""
    return F.max_pool2d(x, 2, stride=2, ceil_mode=True)


def _up_to(x, target):
    """Bilinear resize to target's spatial size (align_corners=False)."""
    return F.interpolate(x, size=target.shape[2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """Residual U-block of configurable depth (RSU7..RSU4)."""

    def __init__(self, depth, in_ch, mid, out):
        super().__init__()
        self.depth = depth
        self.convin = ConvBNRelu(in_ch, out)
        self.enc = nn.ModuleList(ConvBNRelu(out if d == 0 else mid, mid)
                                 for d in range(depth - 1))
        self.bottom = ConvBNRelu(mid, mid, dilation=2)
        self.dec = nn.ModuleList(ConvBNRelu(2 * mid, out if d == 0 else mid)
                                 for d in range(depth - 1))

    def forward(self, x):
        xin = self.convin(x)
        encs = []
        h = xin
        for d, conv in enumerate(self.enc):
            h = conv(h)
            encs.append(h)
            if d < self.depth - 2:
                h = _down(h)
        h = self.bottom(h)
        for d in reversed(range(self.depth - 1)):
            skip = encs[d]
            if h.shape[2:] != skip.shape[2:]:
                h = _up_to(h, skip)
            h = self.dec[d](torch.cat([h, skip], 1))
        return h + xin

    def flax_layout(self, path):
        leaves = self.convin.flax_layout(path + ("convin",))
        for d in range(self.depth - 1):
            leaves += self.enc[d].flax_layout(path + (f"enc{d}",))
            leaves += self.dec[d].flax_layout(path + (f"dec{d}",))
        return leaves + self.bottom.flax_layout(path + ("bottom",))


class RSU4F(nn.Module):
    """Dilated variant: no pooling, dilation rates 1/2/4/8."""

    def __init__(self, in_ch, mid, out):
        super().__init__()
        self.convin = ConvBNRelu(in_ch, out)
        self.enc0 = ConvBNRelu(out, mid, 1)
        self.enc1 = ConvBNRelu(mid, mid, 2)
        self.enc2 = ConvBNRelu(mid, mid, 4)
        self.bottom = ConvBNRelu(mid, mid, 8)
        self.dec2 = ConvBNRelu(2 * mid, mid, 4)
        self.dec1 = ConvBNRelu(2 * mid, mid, 2)
        self.dec0 = ConvBNRelu(2 * mid, out, 1)

    def forward(self, x):
        xin = self.convin(x)
        h1 = self.enc0(xin)
        h2 = self.enc1(h1)
        h3 = self.enc2(h2)
        h4 = self.bottom(h3)
        d3 = self.dec2(torch.cat([h4, h3], 1))
        d2 = self.dec1(torch.cat([d3, h2], 1))
        return self.dec0(torch.cat([d2, h1], 1)) + xin

    def flax_layout(self, path):
        leaves = []
        for name in ("convin", "enc0", "enc1", "enc2", "bottom", "dec2", "dec1", "dec0"):
            leaves += getattr(self, name).flax_layout(path + (name,))
        return leaves


class U2NETP(nn.Module):
    """(B, H, W, 3) normalized -> (B, H, W, 1) saliency in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.stage1 = RSU(7, 3, 16, 64)
        self.stage2 = RSU(6, 64, 16, 64)
        self.stage3 = RSU(5, 64, 16, 64)
        self.stage4 = RSU(4, 64, 16, 64)
        self.stage5 = RSU4F(64, 16, 64)
        self.stage6 = RSU4F(64, 16, 64)
        self.stage5d = RSU4F(128, 16, 64)
        self.stage4d = RSU(4, 128, 16, 64)
        self.stage3d = RSU(5, 128, 16, 64)
        self.stage2d = RSU(6, 128, 16, 64)
        self.stage1d = RSU(7, 128, 16, 64)
        self.sides = nn.ModuleList(nn.Conv2d(64, 1, 3, padding=1) for _ in range(6))
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        e1 = self.stage1(x)
        e2 = self.stage2(_down(e1))
        e3 = self.stage3(_down(e2))
        e4 = self.stage4(_down(e3))
        e5 = self.stage5(_down(e4))
        e6 = self.stage6(_down(e5))
        d5 = self.stage5d(torch.cat([_up_to(e6, e5), e5], 1))
        d4 = self.stage4d(torch.cat([_up_to(d5, e4), e4], 1))
        d3 = self.stage3d(torch.cat([_up_to(d4, e3), e3], 1))
        d2 = self.stage2d(torch.cat([_up_to(d3, e2), e2], 1))
        d1 = self.stage1d(torch.cat([_up_to(d2, e1), e1], 1))
        sides = []
        for conv, stage in zip(self.sides, (d1, d2, d3, d4, d5, e6)):
            s = conv(stage)
            sides.append(_up_to(s, x) if s.shape[2] != x.shape[2] else s)
        fused = self.outconv(torch.cat(sides, 1))
        return torch.sigmoid(fused).permute(0, 2, 3, 1)

    def flax_layout(self):
        leaves = []
        for name in ("stage1", "stage2", "stage3", "stage4", "stage5", "stage6",
                     "stage5d", "stage4d", "stage3d", "stage2d", "stage1d"):
            leaves += getattr(self, name).flax_layout((name,))
        for i, conv in enumerate(self.sides):
            leaves += P.conv(("params", f"side{i + 1}"), conv)
        return leaves + P.conv(("params", "outconv"), self.outconv)
