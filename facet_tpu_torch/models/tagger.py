"""Zero-shot CLIP tagger over the config vocabulary.

Counterpart of ``facet_tpu/models/tagger.py``: each tag's synonyms render
as "a photo of {synonym}"; the prompt matrix comes from
``pretrained_models/tag_embeddings.npz``, a text encoder, or a deterministic
hash-seeded pseudo-embedding per prompt, built exactly as the JAX package
builds it. A photo's stored embedding is scored by cosine similarity, each
tag takes the max over its synonyms (a segment max), tags at or above the
threshold are kept, sorted and truncated to max_tags.
"""

import hashlib
import os

import numpy as np
import torch


def _pseudo_embedding(text, dim):
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
    vec = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    return vec / np.linalg.norm(vec)


def tag_similarities(photo_embeddings, prompt_matrix, segment_ids, num_tags):
    """(N, D) x (D, P) -> per-tag max similarity (N, T)."""
    sims = photo_embeddings @ prompt_matrix                         # (N, P)
    out = torch.full((sims.shape[0], num_tags), float("-inf"),
                     dtype=sims.dtype, device=sims.device)
    index = segment_ids.long()[None, :].expand_as(sims)
    return out.scatter_reduce(1, index, sims, reduce="amax", include_self=True)


class CLIPTagger:
    def __init__(self, config, text_encoder=None, embedding_dim=768,
                 assets_path="pretrained_models/tag_embeddings.npz", device="cpu"):
        self.config = config
        self.device = device
        clip_settings = config.get_clip_settings()
        self.threshold = clip_settings.get("similarity_threshold_percent", 22) / 100
        self.max_tags = config.get_tagging_settings().get("max_tags", 5)
        self.vocabulary = config.get_tag_vocabulary()   # {tag: [synonyms]}
        self.embedding_dim = embedding_dim

        self.tags = list(self.vocabulary.keys())
        prompts, segment_ids = [], []
        for t, tag in enumerate(self.tags):
            synonyms = self.vocabulary[tag] or [tag]
            for syn in synonyms:
                prompts.append(f"a photo of {syn}")
                segment_ids.append(t)
        self.prompts = prompts
        self.segment_ids = np.asarray(segment_ids, np.int32)
        self.prompt_matrix = self._build_prompt_matrix(text_encoder, assets_path)

    def _build_prompt_matrix(self, text_encoder, assets_path):
        if assets_path and os.path.exists(assets_path):
            data = np.load(assets_path, allow_pickle=True)
            stored = {p: e for p, e in zip(data["prompts"], data["embeddings"])}
            if all(p in stored for p in self.prompts):
                mat = np.stack([stored[p] for p in self.prompts])
                return mat.T.astype(np.float32)
        if text_encoder is not None:
            emb = text_encoder(self.prompts)                     # (P, D)
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            return emb.T.astype(np.float32)
        mat = np.stack([_pseudo_embedding(p, self.embedding_dim)
                        for p in self.prompts])
        return mat.T.astype(np.float32)

    def tag_embeddings(self, embeddings):
        """(N, D) float32 normalized photo embeddings -> list of tag lists,
        each [(tag, similarity)], thresholded and truncated."""
        if len(embeddings) == 0:
            return []
        with torch.no_grad():
            sims = tag_similarities(
                torch.as_tensor(np.asarray(embeddings, np.float32), device=self.device),
                torch.as_tensor(self.prompt_matrix, device=self.device),
                torch.as_tensor(self.segment_ids, device=self.device),
                len(self.tags)).cpu().numpy()
        results = []
        for row in sims:
            hits = [(self.tags[t], float(row[t]))
                    for t in np.nonzero(row >= self.threshold)[0]]
            hits.sort(key=lambda kv: kv[1], reverse=True)
            results.append(hits[: self.max_tags])
        return results

    def tag_embedding_bytes(self, blobs):
        """List of stored embedding blobs -> list of tag lists."""
        embeddings = np.stack([
            np.frombuffer(b, dtype=np.float32) for b in blobs
        ]) if blobs else np.zeros((0, self.embedding_dim), np.float32)
        return self.tag_embeddings(embeddings)
