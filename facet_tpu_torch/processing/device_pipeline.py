"""The fused scoring pass: every per-image device result from one resident
uint8 batch.

Counterpart of ``facet_tpu/processing/device_pipeline.py``
(``build_fused_pipeline`` and ``FusedScorer``). Per image shape and chunk of
256 it computes the technical statistics (kernels 1 and 5, or 4 and 5 with
``FACET_ENTROPY_IMPL=pallas_fused``; see ``ops/stats.py``), the pHash bits,
the CLIP crop (separable-matmul resize), the ViT forward, the aesthetic
head and the normalized embedding. The ViT's attention schedule
(``FACET_ATTN_IMPL``: xla, or kernel 6 with ``psoftmax``, or kernel 7 with
``flash``; see ``models/clip.py``) is read once per scorer, as the JAX
package reads it once per fused pipeline.

Joint dispatch: the uint8 chunk crosses host->device once; the fused work,
SCRFD's detection program (the face pipeline) and every rider (TOPIQ,
SAMP-Net) are launched on that same CUDA tensor back to back, then the host
synchronizes once and fetches everything.

Left out on purpose: the device mesh and ``shard_map`` (they return with
multi-GPU data parallelism) and the power-of-two batch padding, which only
bounded XLA recompiles; eager PyTorch has none, so padding would only
waste work.
"""

import numpy as np
import torch

from facet_tpu_torch.models.clip import check_quant_impl, resolve_attn_impl
from facet_tpu_torch.ops.colorspace import rgb_to_gray
from facet_tpu_torch.ops.phash import _bits_to_hex, hash_bits, hash_matrices, low_frequencies
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.resize import apply_separable_resize, clip_preprocess_matrices
from facet_tpu_torch.ops.stats import (
    CHUNK, batch_stats, resolve_entropy_impl, stats_from_outputs)

_STAT_KEYS = ("gray_hist", "sat", "hs_entropy", "lap", "lapsq", "imm")


def _to_numpy(tree):
    if tree is None:
        return None
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


# How many images of the resident batch one rider call takes (TOPIQ,
# SAMP-Net, SCRFD's detection). The JAX package capped TOPIQ at 16 images
# per call for 16 GB of HBM; here the slice comes from the card's free
# memory. One image costs its member's activations, act_bytes_per_pixel
# bytes for each pixel of the member's input size (each member's constant,
# from its activation peak measured by ``chip_smoke.py --probe``), plus the
# f32 copy and first resize pass of the source image (2 * 12 bytes per
# source pixel); a slice may use half the free memory at the time the rider
# is built. On the CPU a slice is 16 images.
MAX_RIDER_SLICE = 256


def rider_slice_size(device, h, w, input_size, act_bytes_per_pixel):
    if torch.device(device).type != "cuda":
        return 16
    free, _ = torch.cuda.mem_get_info(device)
    per_image = act_bytes_per_pixel * input_size ** 2 + 24 * h * w
    return int(max(1, min(MAX_RIDER_SLICE, (free // 2) // per_image)))


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
        # the ViT's attention schedule, read once here (FACET_ATTN_IMPL) and
        # passed to each forward: the shared tower is not changed
        self.attn_impl = resolve_attn_impl(seq_len=aesthetic.config.seq_len)
        check_quant_impl()
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
            out["aesthetic"], out["embedding"] = self.aesthetic.forward_crops(
                crops, self.attn_impl)
        return out

    def score_images(self, images, face_pipeline=None, riders=None):
        """List of RGB uint8 arrays -> aligned list of
        (aesthetic, embedding_bytes, phash_hex, ImageStats).

        ``face_pipeline``: its detection program (letterbox, SCRFD, top-k
        decode) runs on the same resident batch, and the host decodes the
        fetched candidates into per-image detections (``detect_batch``'s
        format). ``riders``: name -> scorer exposing
        ``rider(h, w) -> (run, finish)`` (TOPIQ, SAMP-Net), each run on the
        same resident batch. Everything is fetched together, once per chunk.

        Returns ``results`` alone with neither, else ``(results,
        detections, rider_results)``: detections are None without
        ``face_pipeline``, and rider_results maps each rider name to its
        aligned output list.
        """
        results = [None] * len(images)
        plain = face_pipeline is None and riders is None
        detections = [None] * len(images) if face_pipeline is not None else None
        riders = riders or {}
        rider_results = {name: [None] * len(images) for name in riders}
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape[:2], []).append(i)
        for (h, w), all_idxs in by_shape.items():
            det_run = det_scale = None
            if face_pipeline is not None:
                det_run, det_scale = face_pipeline._detect_program(h, w)
            progs = {name: scorer.rider(h, w) for name, scorer in riders.items()}
            for start in range(0, len(all_idxs), CHUNK):
                idxs = all_idxs[start:start + CHUNK]
                batch = np.stack([images[i] for i in idxs])
                dev = torch.from_numpy(batch).to(self.device)     # one copy in
                out = self.run(dev)
                det_out = det_run(dev) if det_run is not None else None
                rider_out = {name: run(dev) for name, (run, _) in progs.items()}
                out, det_out, rider_out = fetch([out, det_out, rider_out], self.device)
                if det_run is not None:
                    for idx, dets in zip(idxs, face_pipeline.decode_detections(
                            det_out, det_scale, len(idxs))):
                        detections[idx] = dets
                for name, (_, finish) in progs.items():
                    for idx, val in zip(idxs, finish(rider_out[name], len(idxs))):
                        rider_results[name][idx] = val
                self._collect(out, idxs, h, w, results)
        return results if plain else (results, detections, rider_results)

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
