"""CLIP + MLP aesthetic model (the 'clip-mlp' scorer).

Counterpart of ``facet_tpu/models/aesthetic.py``: features = CLIP ViT-L/14
image features of the 224 px shortest-side-resized, center-cropped,
CLIP-normalized image; raw = MLP(768 -> 256 -> relu -> 1)(features);
aesthetic = clamp((raw + 1) * 5, 0, 10); the stored embedding is the
L2-normalized feature vector as float32 bytes.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.models.clip import (
    CLIPVisionTower,
    clip_vision_config_from,
    normalize_pixels,
)


class AestheticHead(nn.Module):
    """768 -> 256 -> relu -> 1, in float32. ``normalize_input`` is set for the
    converted improved-aesthetic-predictor checkpoint (its tree carries
    ``meta/normalize_input``), which scores L2-normalized embeddings."""

    def __init__(self, in_dim=768, hidden=256, normalize_input=False):
        super().__init__()
        self.normalize_input = normalize_input
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, features):
        if self.normalize_input:
            features = features / torch.linalg.norm(features, dim=-1, keepdim=True)
        return self.fc2(F.relu(self.fc1(features)))

    def flax_layout(self):
        return (P.dense(("params", "fc1"), self.fc1)
                + P.dense(("params", "fc2"), self.fc2))


def aesthetic_from_raw(raw):
    return torch.clamp((raw + 1.0) * 5.0, 0.0, 10.0)


class AestheticScorer:
    """CLIP tower + head on one device; params float32, compute ``dtype``."""

    def __init__(self, vision, head, device):
        self.vision = vision.to(device).eval()
        self.head = head.to(device).eval()
        self.config = vision.config
        self.device = torch.device(device)

    @classmethod
    def create(cls, config, cached, device, dtype=torch.bfloat16):
        """From the host cache > converted checkpoints > fallback init
        (CLIP vision seed 0, head seed 1, as the JAX package)."""
        clip_settings = config.get_clip_settings() if config else {}
        vcfg = clip_vision_config_from(clip_settings)
        vision = CLIPVisionTower(vcfg, dtype)
        if cached is not None:
            head = AestheticHead(vcfg.projection_dim,
                                 normalize_input=cached["normalize_input"])
            vision.load_state_dict(cached["vision"])
            head.load_state_dict(cached["head"])
            return cls(vision, head, device)
        P.init_or_load(vision, "clip_vit_l14_vision", seed=0)
        tree = P.load_npz("aesthetic_head")
        meta = (tree or {}).get("meta", {})
        head = AestheticHead(vcfg.projection_dim, normalize_input=bool(
            np.any(np.asarray(meta.get("normalize_input", 0.0)))))
        P.init_or_load(head, "aesthetic_head", seed=1)
        return cls(vision, head, device)

    def host_params(self):
        """CPU state dicts for the model manager's host-RAM cache."""
        cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
        return {"vision": cpu(self.vision), "head": cpu(self.head),
                "normalize_input": self.head.normalize_input}

    @torch.no_grad()
    def forward_crops(self, crops, attn_impl="xla"):
        """(B, 224, 224, 3) f32 crops in [0, 255] on the device ->
        (aesthetic (B,), normalized embedding (B, 768)), un-fetched.
        ``attn_impl``: the ViT's attention schedule (models/clip.py)."""
        features = self.vision(normalize_pixels(crops), attn_impl)
        aesthetic = aesthetic_from_raw(self.head(features)[:, 0])
        return aesthetic, features / torch.linalg.norm(features, dim=-1, keepdim=True)

    @torch.no_grad()
    def score_from_embeddings_batch(self, embedding_matrix):
        """(N, 768) float32 -> (N,) scores."""
        emb = torch.as_tensor(np.asarray(embedding_matrix, np.float32),
                              device=self.device)
        return aesthetic_from_raw(self.head(emb)[:, 0]).cpu().numpy()

