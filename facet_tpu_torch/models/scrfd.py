"""SCRFD face detector (insightface buffalo_l det_10g) in PyTorch.

Counterpart of ``facet_tpu/models/scrfd.py``: a ResNetV1e backbone (deep
3x3 stem, stride 2 then a 3x3/2 max pool; BasicBlocks whose strided
shortcuts average-pool in ceil mode without counting the padding, then a
1x1 conv), a PAFPN neck over C3..C5 at 56 channels (lateral 1x1 convs,
nearest top-down, 3x3 fpn convs, the bottom-up 3x3/2 path) and one head
shared across the three strides (4 conv+BN+ReLU, then 3x3 cls, reg and
kps convs, a scalar scale per stride on reg). Inputs and outputs are NHWC,
as in the JAX package; the network runs NCHW inside.

``decode_topk`` is insightface's decode (anchor centres at (x, y) * stride
with no half-pixel offset, distances and keypoint offsets times the
stride) followed by the k best scores of each image. It orders the scores
with a stable descending sort, so equal scores keep their anchor order, as
``jax.lax.top_k`` keeps it; ``torch.topk`` promises no order for ties.

The converters of the JAX package (``convert_scrfd``,
``infer_scrfd_config``) are not ported: the port loads the flax tree they
write (``pretrained_models/scrfd_detector.npz``) through ``params.py``.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P


@dataclass(frozen=True)
class SCRFDConfig:
    stem_channels: int = 28                 # first two stem convs
    base_channels: int = 56                 # stem output / stage-1 input
    stage_blocks: tuple = (3, 4, 2, 3)
    stage_planes: tuple = (56, 88, 88, 224)
    neck_channels: int = 56
    feat_channels: int = 80
    stacked_convs: int = 4
    num_anchors: int = 2
    strides: tuple = (8, 16, 32)
    input_size: int = 640
    use_scale: bool = True


SCRFD_10G = SCRFDConfig()


def _conv(in_ch, out_ch, kernel, stride=1, bias=False):
    """torch Conv2d(k, stride, padding=k//2): the JAX package's explicit
    symmetric padding."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2, bias=bias)


def avg_pool_ceil(x, k):
    """AvgPool2d(k, k, ceil_mode=True, count_include_pad=False), NCHW."""
    return F.avg_pool2d(x, k, stride=k, ceil_mode=True, count_include_pad=False)


def upsample_nearest(x, out_h, out_w):
    """F.interpolate(mode='nearest', size=...) in integer arithmetic: the
    floor index mapping, NCHW."""
    h, w = x.shape[2:]
    if out_h == 2 * h and out_w == 2 * w:
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    ri = (torch.arange(out_h, device=x.device) * h) // out_h
    ci = (torch.arange(out_w, device=x.device) * w) // out_w
    return x[:, :, ri][:, :, :, ci]


class BasicBlockV1e(nn.Module):
    """mmcv BasicBlock with the avg_down shortcut (ResNetV1d/e)."""

    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(in_ch, planes, 3, stride)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1)
        self.bn2 = nn.BatchNorm2d(planes)
        self.down = stride != 1 or in_ch != planes
        if self.down:
            self.down_conv = nn.Conv2d(in_ch, planes, 1, bias=False)
            self.down_bn = nn.BatchNorm2d(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down:
            if self.stride != 1:     # avg_down: pool, then a 1x1 conv at stride 1
                x = avg_pool_ceil(x, self.stride)
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = (P.conv(p + ("conv1",), self.conv1) + P.batch_norm(path + ("bn1",), self.bn1)
                  + P.conv(p + ("conv2",), self.conv2) + P.batch_norm(path + ("bn2",), self.bn2))
        if self.down:
            leaves += (P.conv(p + ("down_conv",), self.down_conv)
                       + P.batch_norm(path + ("down_bn",), self.down_bn))
        return leaves


class ResNetV1e(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        sc, bc = cfg.stem_channels, cfg.base_channels
        self.stem = nn.ModuleList([_conv(3, sc, 3, 2), _conv(sc, sc, 3, 1), _conv(sc, bc, 3, 1)])
        self.stem_bn = nn.ModuleList([nn.BatchNorm2d(sc), nn.BatchNorm2d(sc), nn.BatchNorm2d(bc)])
        self.stages = []
        in_ch = bc
        for stage, (blocks, planes) in enumerate(zip(cfg.stage_blocks, cfg.stage_planes),
                                                 start=1):
            names = []
            for i in range(blocks):
                stride = 2 if (i == 0 and stage > 1) else 1
                name = f"layer{stage}_{i}"
                self.add_module(name, BasicBlockV1e(in_ch, planes, stride))
                names.append(name)
                in_ch = planes
            self.stages.append(names)

    def forward(self, x):
        for conv, bn in zip(self.stem, self.stem_bn):
            x = F.relu(bn(conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs     # C2..C5 at strides 4/8/16/32

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = []
        for i, (conv, bn) in enumerate(zip(self.stem, self.stem_bn)):
            leaves += P.conv(p + (f"stem{i}",), conv) + P.batch_norm(path + (f"stem_bn{i}",), bn)
        for names in self.stages:
            for name in names:
                leaves += getattr(self, name).flax_layout(path + (name,))
        return leaves


class PAFPN(nn.Module):
    """mmdet PAFPN, start_level 1, num_outs 3, no norm or activation."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg.neck_channels
        n = len(cfg.strides)
        self.lateral = nn.ModuleList(nn.Conv2d(cin, c, 1) for cin in cfg.stage_planes[1:])
        self.fpn = nn.ModuleList(_conv(c, c, 3, 1, bias=True) for _ in range(n))
        self.downsample = nn.ModuleList(_conv(c, c, 3, 2, bias=True) for _ in range(n - 1))
        self.pafpn = nn.ModuleList(_conv(c, c, 3, 1, bias=True) for _ in range(n - 1))

    def forward(self, feats):
        laterals = [conv(f) for conv, f in zip(self.lateral, feats[1:])]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(laterals[i], h, w)
        inter = [conv(lat) for conv, lat in zip(self.fpn, laterals)]
        for i in range(len(inter) - 1):
            inter[i + 1] = inter[i + 1] + self.downsample[i](inter[i])
        return [inter[0]] + [self.pafpn[i - 1](inter[i]) for i in range(1, len(inter))]

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = []
        for name in ("lateral", "fpn", "downsample", "pafpn"):
            for i, conv in enumerate(getattr(self, name)):
                leaves += P.conv(p + (f"{name}{i}",), conv)
        return leaves


class SCRFDHead(nn.Module):
    """Shared head (strides_share + cls_reg_share): one ConvModule stack,
    cls/reg/kps 3x3 convs, a scalar scale per stride on reg."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        a = cfg.num_anchors
        chans = [cfg.neck_channels] + [cfg.feat_channels] * cfg.stacked_convs
        self.convs = nn.ModuleList(_conv(chans[i], chans[i + 1], 3)
                                   for i in range(cfg.stacked_convs))
        self.bns = nn.ModuleList(nn.BatchNorm2d(cfg.feat_channels)
                                 for _ in range(cfg.stacked_convs))
        self.cls = nn.Conv2d(cfg.feat_channels, a, 3, padding=1)
        self.reg = nn.Conv2d(cfg.feat_channels, a * 4, 3, padding=1)
        self.kps = nn.Conv2d(cfg.feat_channels, a * 10, 3, padding=1)
        self.scales = nn.ParameterList(nn.Parameter(torch.ones(()))
                                       for _ in range(len(cfg.strides) if cfg.use_scale else 0))

    def forward(self, feats):
        a = self.cfg.num_anchors
        outputs = []
        for level, feat in enumerate(feats):
            t = feat
            for conv, bn in zip(self.convs, self.bns):
                t = F.relu(bn(conv(t)))
            cls = torch.sigmoid(self.cls(t)).permute(0, 2, 3, 1)
            reg = self.reg(t)
            if self.cfg.use_scale:
                reg = reg * self.scales[level]
            reg = reg.permute(0, 2, 3, 1)
            kps = self.kps(t).permute(0, 2, 3, 1)
            b, h, w, _ = cls.shape
            outputs.append((cls, reg.reshape(b, h, w, a, 4), kps.reshape(b, h, w, a, 10)))
        return outputs

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = []
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            leaves += P.conv(p + (f"conv{i}",), conv) + P.batch_norm(path + (f"bn{i}",), bn)
        for name in ("cls", "reg", "kps"):
            leaves += P.conv(p + (name,), getattr(self, name))
        for level, scale in enumerate(self.scales):
            leaves += P.raw(p + (f"scale{level}",), scale)
        return leaves


class SCRFD(nn.Module):
    """det_10g: (B, S, S, 3) normalized input -> per stride
    (scores (B, H, W, A), distances (B, H, W, A, 4), kps (B, H, W, A, 10)),
    distances and keypoints in stride units like the ONNX outputs."""

    def __init__(self, config=SCRFD_10G):
        super().__init__()
        self.config = config
        self.backbone = ResNetV1e(config)
        self.neck = PAFPN(config)
        self.head = SCRFDHead(config)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x.permute(0, 3, 1, 2))))

    def flax_layout(self):
        return (self.backbone.flax_layout(("backbone",)) + self.neck.flax_layout(("neck",))
                + self.head.flax_layout(("head",)))


def decode_topk(outputs, strides=(8, 16, 32), k=64, center_offset=0.0):
    """Decode every anchor's box and keypoints on the device and keep the
    k best by score per image -> (scores (B, k), boxes (B, k, 4),
    kps (B, k, 5, 2)), the scores in descending order."""
    all_scores, all_boxes, all_kps = [], [], []
    for (scores, boxes, kps), stride in zip(outputs, strides):
        b, h, w, a = scores.shape
        dev = scores.device
        cx = ((torch.arange(w, device=dev, dtype=torch.float32) + center_offset)
              * stride)[None, None, :, None].expand(b, h, w, a)
        cy = ((torch.arange(h, device=dev, dtype=torch.float32) + center_offset)
              * stride)[None, :, None, None].expand(b, h, w, a)
        d = boxes * stride
        box = torch.stack([cx - d[..., 0], cy - d[..., 1],
                           cx + d[..., 2], cy + d[..., 3]], dim=-1)
        pts = (kps.reshape(b, h, w, a, 5, 2) * stride
               + torch.stack([cx, cy], dim=-1)[..., None, :])
        all_scores.append(scores.reshape(b, -1))
        all_boxes.append(box.reshape(b, -1, 4))
        all_kps.append(pts.reshape(b, -1, 5, 2))
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    kps = torch.cat(all_kps, dim=1)
    k = min(k, scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    bb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    kk = torch.gather(kps, 1, idx[..., None, None].expand(-1, -1, 5, 2))
    return top, bb, kk
