"""SAMP-Net composition assessment in PyTorch, and the engine's scorer.

Counterpart of ``facet_tpu/models/samp_net.py``: a 224x224
ImageNet-normalized image -> ResNet-18 features (7x7x512) -> pattern-weight
head -> 8 spatial pooling patterns over the features and the U2-Net-P
saliency (assembled to the checkpoint's widths 1296/1373/1324/836, padded
by tiling the global max) -> softmax-weighted 1024-d aggregate -> 6 sigmoid
attributes and a 5-class score distribution. The expected score over
{1..5} rescales to 0-10; the dominant pattern is the argmax pattern weight.

The pooling assembly runs NHWC, line for line as in the JAX package; the
backbone runs NCHW. One resize needs care: the saliency map goes from 56x56
to the 7x7 feature grid through ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples, so the port uses ``F.interpolate`` with
``antialias=True`` (the plain bilinear form misses that grid by more than
1e-2 on tests/test_torch_samp.py's inputs).

``SAMPComposition`` resizes the resident uint8 batch to 224 on the device
(the ``resample_matrix`` weights of the JAX package), runs U2-Net-P and
SAMP-Net in full float32, and rides the fused pass like TOPIQ does.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.models.u2netp import U2NETP
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.resize import resample_matrix
from facet_tpu_torch.processing.device_pipeline import rider_slice_size

COMPOSITION_PATTERNS = [
    "global", "horizontal", "vertical", "triangular",
    "surround", "quarter", "cross", "rule_of_thirds",
]

# checkpoint-exact assembled conv input shapes per pattern
PATTERN_SHAPES = [(1296, 2, 1), (1296, 1, 2), (1373, 2, 1), (1373, 2, 1),
                  (1296, 2, 1), (1296, 2, 2), (1324, 2, 2), (836, 3, 3)]
PATTERN_KERNELS = [(2, 1), (1, 2), (2, 1), (2, 1), (2, 1), (2, 2), (2, 2), (3, 3)]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
INPUT_SIZE = 224
# Activation bytes of one image per pixel of the 224 px input (U2-Net-P and
# SAMP-Net in f32), for the rider's slice size
# (processing/device_pipeline.py:rider_slice_size): 1258 measured on an
# H100 80GB HBM3 at 700 W (chip_smoke.py --probe), rounded up to a power
# of two.
ACT_BYTES_PER_INPUT_PIXEL = 2048


# ---------------------------------------------------------------- backbone


class BasicBlock(nn.Module):
    def __init__(self, in_ch, features, stride=1):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(features)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.down = stride != 1 or in_ch != features
        if self.down:
            self.down_conv = nn.Conv2d(in_ch, features, 1, stride=stride, bias=False)
            self.down_bn = nn.BatchNorm2d(features)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)

    def flax_layout(self, path):
        p = ("params",) + path
        leaves = []
        for i in range(2):
            leaves += P.conv(p + (f"Conv_{i}",), getattr(self, f"conv{i}"))
            leaves += P.batch_norm(path + (f"BatchNorm_{i}",), getattr(self, f"bn{i}"))
        if self.down:
            leaves += P.conv(p + ("down_conv",), self.down_conv)
            leaves += P.batch_norm(path + ("down_bn",), self.down_bn)
        return leaves


class ResNet18Features(nn.Module):
    """NCHW 224x224x3 -> 7x7x512 feature map (torchvision resnet18 children[:-2])."""

    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = nn.BatchNorm2d(64)
        self.names = []
        in_ch = 64
        for stage, (feats, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            for i in range(2):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, BasicBlock(in_ch, feats, stride if i == 0 else 1))
                self.names.append(name)
                in_ch = feats

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.names:
            x = getattr(self, name)(x)
        return x

    def flax_layout(self, path):
        leaves = (P.conv(("params",) + path + ("Conv_0",), self.conv0)
                  + P.batch_norm(path + ("BatchNorm_0",), self.bn0))
        for name in self.names:
            leaves += getattr(self, name).flax_layout(path + (name,))
        return leaves


# ------------------------------------------------------------ pooling utils


def _adaptive_pool(x, out_h, out_w, mode="avg"):
    """torch adaptive pooling bounds on NHWC (static small outputs)."""
    h, w = x.shape[1], x.shape[2]
    rows = []
    for i in range(out_h):
        h0, h1 = (i * h) // out_h, -(-((i + 1) * h) // out_h)
        cols = []
        for j in range(out_w):
            w0, w1 = (j * w) // out_w, -(-((j + 1) * w) // out_w)
            region = x[:, h0:h1, w0:w1, :]
            cols.append(region.mean(dim=(1, 2)) if mode == "avg"
                        else region.amax(dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)  # (B, out_h, out_w, C)


def _maxpool_k3s2p1(x):
    """NHWC 3x3/2 max pool with -inf padding 1."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)


def _gmax(x):
    return x.amax(dim=(1, 2))


def _gavg(x):
    return x.mean(dim=(1, 2))


def _fit(feat, total, pad_source):
    """Pad (tiling pad_source) or truncate to the checkpoint's exact width."""
    cur = feat.shape[1]
    if cur < total:
        need = total - cur
        reps = -(-need // pad_source.shape[1])
        pad = pad_source.repeat(1, reps)[:, :need]
        feat = torch.cat([feat, pad], dim=1)
    elif cur > total:
        feat = feat[:, :total]
    return feat


def saliency_to_grid(saliency, h, w):
    """(B, 224, 224, 1) saliency -> (B, h, w, 1): two 3x3/2 max pools to
    56x56, then the antialiased bilinear resize ``jax.image.resize`` does."""
    sal = _maxpool_k3s2p1(_maxpool_k3s2p1(saliency))
    sal = F.interpolate(sal.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return sal.permute(0, 2, 3, 1)


# ----------------------------------------------------------------- SAMP-Net


class SAMPNet(nn.Module):
    """(image (B, 224, 224, 3) normalized, saliency (B, 224, 224, 1)) ->
    (pattern_weights (B, 8), attributes (B, 6), score_dist (B, 5))."""

    def __init__(self, num_patterns=8):
        super().__init__()
        self.num_patterns = num_patterns
        self.backbone = ResNet18Features()
        self.pattern_weight = nn.Linear(512, num_patterns, bias=False)
        self.pattern_convs = nn.ModuleList(
            nn.Conv2d(ch, 1024, kernel, bias=False)
            for (ch, _, _), kernel in zip(PATTERN_SHAPES, PATTERN_KERNELS))
        self.att_feature = nn.Linear(1024, 512, bias=False)
        self.att_pred = nn.Linear(512, 6, bias=False)
        self.com_pred0 = nn.Linear(1024, 1024, bias=False)
        self.com_pred3 = nn.Linear(1024, 512, bias=False)
        self.com_pred5 = nn.Linear(512, 5, bias=False)

    def forward(self, image, saliency):
        fmap = self.backbone(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, h, w, _ = fmap.shape

        pattern_weights = self.pattern_weight(F.relu(_gavg(fmap)))
        sal = saliency_to_grid(saliency, h, w)

        global_max = _gmax(fmap)
        global_avg = _gavg(fmap)
        sal_small = _adaptive_pool(sal, 4, 4, "avg").reshape(b, -1)   # 16

        halves_h = (fmap[:, : h // 2], fmap[:, h // 2:])
        halves_w = (fmap[:, :, : w // 2], fmap[:, :, w // 2:])
        center = fmap[:, h // 4: h - h // 4, w // 4: w - w // 4]

        def two_region(r1, r2):
            return torch.cat([_gmax(r1), _gavg(r1), _gmax(r2), _gavg(r2), sal_small], dim=1)

        assembled = [two_region(*halves_h), two_region(*halves_w)]  # patterns 0, 1
        diag = torch.cat([_gmax(halves_h[0]), _gavg(halves_h[0]), _gmax(halves_h[1]),
                          _gavg(halves_h[1]), _gmax(center), sal_small], dim=1)
        assembled += [diag, diag]                      # patterns 2 and 3 share it
        assembled.append(two_region(center, fmap))     # pattern 4

        quads = [fmap[:, : h // 2, : w // 2], fmap[:, : h // 2, w // 2:],
                 fmap[:, h // 2:, : w // 2], fmap[:, h // 2:, w // 2:]]
        assembled.append(torch.cat(
            [_gmax(q) for q in quads] + [_gavg(q) for q in quads]
            + [_gmax(center), sal_small], dim=1))      # pattern 5

        h3, w3 = h // 3, w // 3
        grid = [_gmax(fmap[:, i * h3: min(h, (i + 1) * h3), j * w3: min(w, (j + 1) * w3)])
                for i in range(3) for j in range(3)]
        assembled.append(torch.cat(grid + [sal_small], dim=1))  # pattern 6

        sal_large = _adaptive_pool(sal, 8, 8, "avg").reshape(b, -1)    # 64
        scales = [_adaptive_pool(fmap, s, s, "avg").reshape(b, -1) for s in (2, 3, 4)]
        weighted = _gavg(fmap * sal)
        assembled.append(torch.cat(
            [global_max, global_avg] + scales + [weighted, sal_large], dim=1))  # 7

        pattern_feats = []
        for idx, conv in enumerate(self.pattern_convs):
            ch, ph, pw = PATTERN_SHAPES[idx]
            feat = _fit(assembled[idx], ch * ph * pw, global_max)
            # channel-major, as torch's view(B, C, H, W) in the original
            pattern_feats.append(conv(feat.reshape(b, ch, ph, pw)).reshape(b, -1))
        pattern_feats = torch.stack(pattern_feats, dim=1)           # (B, 8, 1024)

        weights = torch.softmax(pattern_weights, dim=1)[:, :, None]
        aggregated = torch.sum(pattern_feats * weights, dim=1)      # (B, 1024)

        att = F.relu(self.att_feature(aggregated))
        attributes = torch.sigmoid(self.att_pred(att))
        s = F.relu(self.com_pred0(aggregated))
        s = F.relu(self.com_pred3(s))
        score_dist = torch.softmax(self.com_pred5(s), dim=1)
        return pattern_weights, attributes, score_dist

    def flax_layout(self):
        p = ("params",)
        leaves = self.backbone.flax_layout(("backbone",))
        leaves += P.dense(p + ("pattern_weight",), self.pattern_weight)
        for idx, conv in enumerate(self.pattern_convs):
            leaves += P.conv(p + (f"pattern_conv{idx}",), conv)
        for name in ("att_feature", "att_pred", "com_pred0", "com_pred3", "com_pred5"):
            leaves += P.dense(p + (name,), getattr(self, name))
        return leaves


# -------------------------------------------------------------- scorer API


def to_results(pw, attrs, dist):
    """Raw head outputs -> engine score dicts (the JAX package's
    ``SAMPComposition._to_results``)."""
    results = []
    for i in range(len(pw)):
        weights = np.exp(pw[i] - pw[i].max())
        weights = weights / weights.sum()
        raw = float(np.sum(np.arange(1, 6) * dist[i]))
        score = max(0.0, min(10.0, (raw - 1) / 4.0 * 10.0))
        dominant = int(np.argmax(weights))
        results.append({
            "score": round(score, 2),
            "raw_score": round(raw, 2),
            "pattern": COMPOSITION_PATTERNS[dominant],
            "pattern_index": dominant,
            "pattern_weights": {COMPOSITION_PATTERNS[j]: float(weights[j])
                                for j in range(len(COMPOSITION_PATTERNS))},
            "score_distribution": dist[i].tolist(),
            "attributes": attrs[i].tolist(),
            "power_point_score": round(score / 2, 2),
        })
    return results


class SAMPComposition:
    """Batched composition scorer: uint8 images -> score dicts."""

    def __init__(self, samp, u2, device):
        self.device = torch.device(device)
        self.samp = samp.to(self.device).eval()
        self.u2 = u2.to(self.device).eval()
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._matrices = {}

    @classmethod
    def create(cls, config, cached, device):
        """Host cache > converted checkpoints > fallback init (SAMP-Net seed
        20, U2-Net-P seed 21), as the JAX package builds it."""
        samp, u2 = SAMPNet(), U2NETP()
        if cached is not None:
            samp.load_state_dict(cached["samp"])
            u2.load_state_dict(cached["u2"])
        else:
            P.init_or_load(samp, "samp_net", seed=20)
            P.init_or_load(u2, "u2netp", seed=21)
        return cls(samp, u2, device)

    def host_params(self):
        return {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
                for name, net in (("samp", self.samp), ("u2", self.u2))}

    def _resize_matrices(self, h, w):
        if (h, w) not in self._matrices:
            self._matrices[(h, w)] = (
                torch.from_numpy(resample_matrix(h, INPUT_SIZE, method="linear")).to(self.device),
                torch.from_numpy(resample_matrix(w, INPUT_SIZE, method="linear")).to(self.device))
        return self._matrices[(h, w)]

    def forward_pixels(self, pixels):
        """(B, 224, 224, 3) float32 in [0, 255] -> the three heads."""
        norm = (pixels / 255.0 - self.mean) / self.std
        return self.samp(norm, self.u2(norm))

    @torch.no_grad()
    def forward_u8(self, batch_u8):
        """(B, H, W, 3) uint8 on the device -> (pattern_weights, attributes,
        score_dist), un-fetched: the 224 px resize, U2-Net-P and SAMP-Net,
        all in full float32."""
        rows, cols = self._resize_matrices(*batch_u8.shape[1:3])
        with full_float32():
            x = batch_u8.to(torch.float32)
            x = torch.einsum("rh,bhwc->brwc", rows, x)
            x = torch.einsum("sw,brwc->brsc", cols, x)
            return self.forward_pixels(x)

    def rider(self, h, w):
        """(run, finish) for joint dispatch on the fused pass's resident
        batch: ``run`` launches the program slice by slice and returns
        un-fetched outputs; ``finish`` takes them fetched, with the image
        count, and yields the score dicts."""
        cap = rider_slice_size(self.device, h, w, INPUT_SIZE, ACT_BYTES_PER_INPUT_PIXEL)

        def run(dev):
            return [self.forward_u8(dev[i:i + cap]) for i in range(0, dev.shape[0], cap)]

        def finish(fetched, n):
            pw, attrs, dist = (np.concatenate([np.asarray(o[k]) for o in fetched])[:n]
                               for k in range(3))
            return to_results(pw, attrs, dist)

        return run, finish

    def score_batch(self, images):
        """RGB uint8 arrays (any sizes) -> list of score dicts, one device
        program per source shape."""
        if not images:
            return []
        results = [None] * len(images)
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape[:2], []).append(i)
        for (h, w), idxs in by_shape.items():
            run, finish = self.rider(h, w)
            batch = torch.from_numpy(np.stack([images[i] for i in idxs])).to(self.device)
            out = [[t.cpu().numpy() for t in o] for o in run(batch)]
            for i, res in zip(idxs, finish(out, len(idxs))):
                results[i] = res
        return results
