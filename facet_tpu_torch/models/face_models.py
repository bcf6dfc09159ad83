"""Face models in PyTorch: ArcFace recognition, 106-point landmarks, and
the host-side decode and alignment helpers.

Counterpart of ``facet_tpu/models/face_models.py``:

- ``IResNet``: arcface_torch's iresnet-50 (IBasicBlocks 3/4/14/3, PReLU,
  channel-first flatten, fc 25088->512, BatchNorm1d features) on 112x112
  aligned crops -> 512-d embeddings;
- ``LandmarkNet``: five stride-2 conv+BN+ReLU layers with flax's "SAME"
  padding (asymmetric at stride 2: the extra row and column go after),
  global mean, two dense layers -> 106 points in 192 px crop space;
- numpy copies of the host helpers ``topk_to_detections``, ``nms``,
  ``umeyama_similarity`` and ``ARCFACE_DST``.

Inputs are NHWC, as in the JAX package; the networks run NCHW inside.
Detection is ``models/scrfd.py``.
"""

import numpy as np
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P


def _same_pad(x, kernel, stride):
    """flax padding="SAME" for an NCHW input: the total padding of each axis
    is split with the smaller half before."""
    pads = []
    for size in (x.shape[3], x.shape[2]):           # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvBN(nn.Module):
    """flax ConvBN: a "SAME" conv without bias, BatchNorm, optional ReLU."""

    def __init__(self, in_ch, features, kernel=3, stride=1, act=True):
        super().__init__()
        self.kernel, self.stride, self.act = kernel, stride, act
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(features)

    def forward(self, x):
        x = self.bn(self.conv(_same_pad(x, self.kernel, self.stride)))
        return F.relu(x) if self.act else x

    def flax_layout(self, path):
        return (P.conv(("params",) + path + ("Conv_0",), self.conv)
                + P.batch_norm(path + ("BatchNorm_0",), self.bn))


def topk_to_detections(top, boxes, kps, score_threshold=0.5):
    """Host side of decode_topk: -> per-image list of (score, bbox, kps5)."""
    top = np.asarray(top)
    boxes = np.asarray(boxes)
    kps = np.asarray(kps)
    results = []
    for bi in range(top.shape[0]):
        dets = []
        for j in range(top.shape[1]):
            if top[bi, j] < score_threshold:
                break  # the scores are sorted descending
            dets.append((float(top[bi, j]), boxes[bi, j].astype(np.float32),
                         kps[bi, j].astype(np.float32)))
        results.append(dets)
    return results


def nms(detections, iou_threshold=0.4):
    """Greedy IoU NMS over [(score, bbox, kps)] for one image."""
    if not detections:
        return []
    detections = sorted(detections, key=lambda d: -d[0])
    kept = []
    for det in detections:
        _, box, _ = det
        keep = True
        for _, kb, _ in kept:
            ix1, iy1 = max(box[0], kb[0]), max(box[1], kb[1])
            ix2, iy2 = min(box[2], kb[2]), min(box[3], kb[3])
            inter = max(0, ix2 - ix1) * max(0, iy2 - iy1)
            area_a = (box[2] - box[0]) * (box[3] - box[1])
            area_b = (kb[2] - kb[0]) * (kb[3] - kb[1])
            union = area_a + area_b - inter
            if union > 0 and inter / union > iou_threshold:
                keep = False
                break
        if keep:
            kept.append(det)
    return kept


# ---------------------------------------------------------------------------
# ArcFace recognition backbone (iResNet-50 shape)
# ---------------------------------------------------------------------------


class IRBlock(nn.Module):
    """IBasicBlock: bn1 -> conv1 (3x3 s1) -> bn2 -> prelu -> conv2 (3x3,
    stride) -> bn3, with a 1x1 conv + bn shortcut when the shape changes."""

    def __init__(self, in_ch, features, stride=1):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, features, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.prelu = nn.PReLU(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(features)
        self.down = in_ch != features or stride != 1
        if self.down:
            self.down_conv = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.down_bn = nn.BatchNorm2d(features)

    def forward(self, x):
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return x + y

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = (P.batch_norm(path + ("bn1",), self.bn1) + P.conv(p + ("conv1",), self.conv1)
                  + P.batch_norm(path + ("bn2",), self.bn2)
                  + P.raw(p + ("prelu", "alpha"), self.prelu.weight)
                  + P.conv(p + ("conv2",), self.conv2) + P.batch_norm(path + ("bn3",), self.bn3))
        if self.down:
            leaves += (P.conv(p + ("down_conv",), self.down_conv)
                       + P.batch_norm(path + ("down_bn",), self.down_bn))
        return leaves


class IResNet(nn.Module):
    """ArcFace iresnet-50: (B, 112, 112, 3) aligned crop -> (B, 512)."""

    def __init__(self, layers=(3, 4, 14, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = nn.PReLU(64)
        self.names = []
        in_ch = 64
        for stage, (blocks, feats) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
            for i in range(blocks):
                name = f"layer{stage}_{i}"
                self.add_module(name, IRBlock(in_ch, feats, stride=2 if i == 0 else 1))
                self.names.append(name)
                in_ch = feats
        self.bn2 = nn.BatchNorm2d(512)
        self.fc = nn.Linear(512 * 7 * 7, 512)
        self.features = nn.BatchNorm1d(512)

    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        for name in self.names:
            x = getattr(self, name)(x)
        x = self.bn2(x)
        # channel-first flatten, as torch's original (the fc weights load so)
        x = self.fc(x.reshape(x.shape[0], -1))
        return self.features(x)

    def flax_layout(self):
        p = ("params",)
        leaves = (P.conv(p + ("conv1",), self.conv1) + P.batch_norm(("bn1",), self.bn1)
                  + P.raw(p + ("prelu", "alpha"), self.prelu.weight))
        for name in self.names:
            leaves += getattr(self, name).flax_layout((name,))
        return (leaves + P.batch_norm(("bn2",), self.bn2) + P.dense(p + ("fc",), self.fc)
                + P.batch_norm(("features",), self.features))


# ---------------------------------------------------------------------------
# 106-point landmark regressor
# ---------------------------------------------------------------------------


class LandmarkNet(nn.Module):
    """(B, 192, 192, 3) aligned crop -> (B, 106, 2) crop-space coordinates."""

    LAYERS = ((32, 2), (64, 2), (64, 2), (128, 2), (128, 2))

    def __init__(self):
        super().__init__()
        chans = [3] + [f for f, _ in self.LAYERS]
        self.convs = nn.ModuleList(ConvBN(chans[i], f, 3, s)
                                   for i, (f, s) in enumerate(self.LAYERS))
        self.dense0 = nn.Linear(128, 256)
        self.dense1 = nn.Linear(256, 212)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = conv(x)
        x = F.relu(self.dense0(x.mean(dim=(2, 3))))
        out = self.dense1(x)
        # the network regresses [-1, 1]; map to crop pixels
        return (out.reshape(-1, 106, 2) + 1.0) * 96.0

    def flax_layout(self):
        leaves = []
        for i, conv in enumerate(self.convs):
            leaves += conv.flax_layout((f"ConvBN_{i}",))
        return (leaves + P.dense(("params", "Dense_0"), self.dense0)
                + P.dense(("params", "Dense_1"), self.dense1))


# ---------------------------------------------------------------------------
# Alignment (host): similarity transform to ArcFace's canonical 5 points
# ---------------------------------------------------------------------------

ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)  # 112x112


def umeyama_similarity(src, dst):
    """Least-squares similarity transform (2x3) mapping src -> dst."""
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    diag = np.diag([1.0, d])
    rotation = u @ diag @ vt
    var_src = (src_c ** 2).sum() / src.shape[0]
    scale = (s * np.diag(diag)).sum() / var_src if var_src > 0 else 1.0
    t = dst_mean - scale * rotation @ src_mean
    m = np.zeros((2, 3), np.float32)
    m[:, :2] = scale * rotation
    m[:, 2] = t
    return m
