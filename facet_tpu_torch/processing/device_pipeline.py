"""The fused scoring pass: every per-image device result from one resident
uint8 batch.

Counterpart of ``facet_tpu/processing/device_pipeline.py``
(``build_fused_pipeline`` and ``FusedScorer``). Per image shape and chunk of
256 it computes the technical statistics (kernels 1 and 5, or 4 and 5 with
``FACET_ENTROPY_IMPL=pallas_fused``; see ``ops/stats.py``), the pHash bits,
the CLIP crop (separable-matmul resize), the ViT forward, the aesthetic
head and the normalized embedding.

Joint dispatch: the uint8 chunk crosses host->device once; the fused work
and every rider (TOPIQ) are launched on that same CUDA tensor back to back,
then the host synchronizes once and fetches everything.

Left out on purpose: the device mesh and ``shard_map`` (they return with
multi-GPU data parallelism) and the power-of-two batch padding, which only
bounded XLA recompiles; eager PyTorch has none, so padding would only
waste work.
"""

import numpy as np
import torch

from facet_tpu_torch.ops.colorspace import rgb_to_gray
from facet_tpu_torch.ops.phash import _bits_to_hex, hash_bits, hash_matrices, low_frequencies
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.resize import apply_separable_resize, clip_preprocess_matrices
from facet_tpu_torch.ops.stats import (
    CHUNK, batch_stats, resolve_entropy_impl, stats_from_outputs)

_STAT_KEYS = ("gray_hist", "sat", "hs_entropy", "lap", "lapsq", "imm")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.cpu().numpy()


def fetch(tree, device):
    """Synchronize the device once, then copy every tensor in a nested
    dict/list to numpy."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return _to_numpy(tree)


class FusedScorer:
    """Aesthetic + embedding + pHash + technical statistics per chunk."""

    def __init__(self, aesthetic, hs_subsample=1, entropy_impl="auto"):
        self.aesthetic = aesthetic          # models.aesthetic.AestheticScorer
        self.device = aesthetic.device
        # fast mode (processing.fast_color_harmony / the fast speed tier):
        # stride the entropy's pixel stream; every other statistic stays exact
        self.hs_subsample = hs_subsample
        # the stats configuration, read once here (FACET_ENTROPY_IMPL)
        self.entropy_impl = resolve_entropy_impl(entropy_impl)
        self._matrices = {}

    def _shape_matrices(self, h, w):
        if (h, w) not in self._matrices:
            rows, cols = clip_preprocess_matrices(h, w, self.aesthetic.config.image_size)
            self._matrices[(h, w)] = (
                torch.from_numpy(rows).to(self.device),
                torch.from_numpy(cols).to(self.device),
                *hash_matrices(h, w, self.device))
        return self._matrices[(h, w)]

    @torch.no_grad()
    def run(self, batch_u8):
        """(B, H, W, 3) uint8 on the device -> dict of un-fetched outputs.
        The float32 resizes, DCT and projection run in full float32."""
        rows, cols, hash_rows, hash_cols, dct = self._shape_matrices(*batch_u8.shape[1:3])
        out = dict(zip(_STAT_KEYS, batch_stats(batch_u8, self.hs_subsample,
                                               self.entropy_impl)))
        with full_float32():
            gray = rgb_to_gray(batch_u8).to(torch.float32)
            out["hash_bits"] = hash_bits(low_frequencies(gray, hash_rows, hash_cols, dct))
            crops = apply_separable_resize(batch_u8, rows, cols)
            out["aesthetic"], out["embedding"] = self.aesthetic.forward_crops(crops)
        return out

    def score_images(self, images, riders=None):
        """List of RGB uint8 arrays -> aligned list of
        (aesthetic, embedding_bytes, phash_hex, ImageStats).

        ``riders``: name -> scorer exposing ``rider(h, w) -> (run, finish)``
        (TOPIQ). Each rider runs on the same resident batch and is fetched
        with the fused outputs; whenever ``riders`` is given the return
        value is ``(results, rider_results)``, rider_results mapping each
        name to its aligned output list.
        """
        results = [None] * len(images)
        riders_passed = riders is not None
        riders = riders or {}
        rider_results = {name: [None] * len(images) for name in riders}
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape[:2], []).append(i)
        for (h, w), all_idxs in by_shape.items():
            progs = {name: scorer.rider(h, w) for name, scorer in riders.items()}
            for start in range(0, len(all_idxs), CHUNK):
                idxs = all_idxs[start:start + CHUNK]
                batch = np.stack([images[i] for i in idxs])
                dev = torch.from_numpy(batch).to(self.device)     # one copy in
                out = self.run(dev)
                rider_out = {name: run(dev) for name, (run, _) in progs.items()}
                out, rider_out = fetch([out, rider_out], self.device)
                for name, (_, finish) in progs.items():
                    for idx, val in zip(idxs, finish(rider_out[name], len(idxs))):
                        rider_results[name][idx] = val
                self._collect(out, idxs, h, w, results)
        if riders_passed:
            return results, rider_results
        return results

    @staticmethod
    def _collect(out, idxs, h, w, results):
        for j, idx in enumerate(idxs):
            stats = stats_from_outputs(h, w, *(out[k][j] for k in _STAT_KEYS))
            results[idx] = (
                float(out["aesthetic"][j]),
                np.asarray(out["embedding"][j], np.float32).tobytes(),
                _bits_to_hex(out["hash_bits"][j]),
                stats,
            )
