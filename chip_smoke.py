"""Smoke test of the PyTorch/CUDA port (facet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_TREE [CHECK ...]
    python3 chip_smoke.py --probe

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: CUDA must be present; print the card's name and power limit and
   which optional host packages import;
2. build: compile every kernel from facet_tpu_torch/csrc (one nvcc per
   source, all started together);
3. kernels against their plain PyTorch twins on the card, at the main
   path's shapes and at odd small ones: kernel 1 (H-S entropy) and kernel 3
   (its fixed denominator), kernel 4 (one-pass RGB stats), kernel 5 (gray
   stencil stats), kernel 2 (TOPIQ's cross-attention), kernel 6 (the ViT's
   row softmax) and kernel 7 (the ViT's fused attention). Histograms and
   integer sums must be identical, entropy within 1e-5, kernel 2 within
   ATTN_TOL and ATTN_REL_RMS_TOL, kernel 6 within one bf16 ulp element by
   element, kernel 7 within one bf16 ulp of its output's magnitude and
   VIT_ATTN_REL_RMS_TOL; for kernels 2 and 7 a planted variant that rounds
   p before normalizing it must fail the relative-RMS limit. Each reports
   the median times of kernel and twin from CUDA events, its bound (the
   least time the card could take for the same work) and, where one
   PyTorch call computes the same function, that call's time on the same
   inputs (F.scaled_dot_product_attention for kernels 2 and 7,
   torch.softmax for kernel 6: yardsticks only, the port never calls
   them). At the main path's shape each also reports its device time per
   call replayed from a CUDA graph (no host launch cost), and so do SDPA
   and torch.softmax beside kernels 2, 7 and 6; kernels 1, 4
   and 5 split their device time by launch (torch.profiler), and kernel 1
   must return bit-identical entropy on three calls. Kernels 1, 4 and 5
   (both entries: from the uint8 RGB, the main path's, and from an int32
   gray plane) are also held to their twins on one 24 MP photo (4000x6000)
   near-uniform and one noisy, past 2^24 pixels of one image. Kernels 2
   and 7 report resident blocks per SM and the bytes staged into shared
   memory (for kernel 2 also through L2), reckoned from the grid; then the
   whole statistics prepass is timed in both configurations (events, a
   CUDA graph, and its device time by launch), and the ViT-L/14 forward
   under each attention schedule;
4. the slice: ``python -m facet_tpu_torch <dir> --pass quality`` in-process
   over synthetic photos at full width (ViT-L/14 at 224 in bf16 with the
   aesthetic head, TOPIQ at 384 in f32), each scan into a fresh database:
   the default configuration (kernels 1, 5 from the RGB, and 2 launch;
   kernel 5 never from a gray plane), then
   FACET_ENTROPY_IMPL=pallas_fused (kernels 4, 5 and 2), then the ViT's
   other attention schedules FACET_ATTN_IMPL=psoftmax (kernel 6) and
   FACET_ATTN_IMPL=flash (kernel 7). Each scan's launch counts are checked
   (kernels 6 and 7 launch once per ViT layer per forward, and in no other
   scan). Every row is checked. The pallas_fused rows must agree with the
   default's (pHash and the integer-derived columns identical,
   raw_color_entropy within 1e-5, stored scores within 1e-3); the psoftmax
   and flash rows too, on what the ViT does not feed (pHash, the
   integer-derived columns, TOPIQ's scores), with each CLIP embedding at
   cosine similarity EMBEDDING_MIN_COSINE or more to the default's. TOPIQ
   must run with TF32 off in every scan although the process keeps torch's
   defaults;
5. the default multi-pass scan, ``python -m facet_tpu_torch <dir>`` with
   ``models.vram_profile: "16gb"`` (clip, topiq, samp_net, insightface in
   one pass group): SCRFD det_10g at 640 px, TOPIQ at 384 and U2-Net-P +
   SAMP-Net at 224 ride the fused pass's resident batch, then the landmark
   net (192 px) and ArcFace (112 px) run on the face crops. SCRFD's three
   reg scales are set to SCRFD_REG_SCALE after its fallback init (which
   leaves them at zero in both packages, so that no box would have a size).
   Checked: kernels 1, 5 and 2 launch (and no other); no member is skipped
   as unavailable; every row is complete, with SAMP-Net's composition (not
   the rule-based analyzer's) and the face columns filled; the faces table
   holds a row per face with 512 float32 values of embedding, 106x2
   landmarks and a JPEG thumbnail (none where the padded box's crop holds
   no pixel of the photo, as in the JAX package); pHash and the integer-derived columns
   equal the default --pass quality scan's (exposure_score within the 2
   places the default scan keeps: a --pass scan's recompute stores 4); each
   new float32 member
   (U2-Net-P, SAMP-Net, SCRFD, the landmark net, ArcFace) and TOPIQ run
   with TF32 off. It prints the scan's images/s and phase times, then each
   new member's device time per batch of 24 at 1024x1536 (CUDA events, and
   replayed from a CUDA graph): the SAMP rider, SCRFD's detection and
   decode, the landmark net and ArcFace on as many crops as the scan found
   faces in those photos;
6. the Qwen2.5-VL-7B tagger and the default scan under ``vram_profile:
   "auto"``, which resolves to the "24gb" profile on the card. First with
   nothing installed: the tagger chain prints its three "unavailable"
   lines and the rows equal phase 5's (CLIP tags; floats within
   SCORE_TOL, CLIP embeddings at cosine EMBEDDING_MIN_COSINE or more).
   Then the tagger at its published widths (vision tower float32, decoder
   bf16, random weights drawn on the card from a seed) with the stand-in
   processor below (the published smart_resize, patch rows and special
   ids; ids decode onto the tag vocabulary): the first decoder layer, the
   first vision block and the merger on 256 tokens against float64 on the
   CPU (LAYER_BF16_REL_TOL, LAYER_F32_REL_TOL); a cached greedy decode of
   two photos of different shapes against the cache-less forward
   (DECODE_LOGIT_TOL); CUDA-event times of the vision encode, the prefill
   and a decode step per batch of two, beside their bounds; the memory
   peak while tagging against the tagger's 18 GB budget; then the scan
   with the tagger registered through ModelManager.register over
   TAGGER_PHOTOS_PER_SHAPE photos of each shape: every row's tags are the
   tagger's own for that photo, no batch skipped, TF32 off inside the
   vision tower. Both scans launch kernels 1, 5 and 2 twice each and no
   other kernel.

The second-to-last line is the kernel report, a JSON object; the last line
is {"ok": true, "device": {...}}.

With ``--ab OTHER_TREE [CHECK ...]`` it runs only the kernel checks
(``softmax`` for kernel 6, ``entropy`` for kernel 1, ``entropy_fixed``
for kernel 3, ``fused_stats`` for kernel 4, ``gray_stats`` for kernel 5,
``attention`` for kernel 2, ``vit_attention`` for kernel 7, ``prepass``
for the whole statistics prepass; all when none is named) on the kernels
of another checkout of the repo
and of this one in turns on one card (other, this, this, other), each tree
in a process of its own that builds that tree's kernels; the checks and
timers are this file's, so both trees are measured alike. For a parent
commit: ``mkdir -p build/parent && git archive <commit> | tar -x -C
build/parent``.

With ``--probe`` it builds the kernels and shows where the default scan
(phase 5's configuration) spends its time, failing on no number: each
rider's activation peak per image (TOPIQ, SAMP, SCRFD's detection, by
``torch.cuda.max_memory_allocated``) beside the bytes per input pixel
that its slice size budgets; then the scan over the smoke's photos three
times on one engine: cold (every model built on first use), warm (models
resident) and warm again under torch.profiler (device activity only).
Each prints its wall time, images/s, the multi-pass processor's phase
times and the host time of each stage (the fused pass with its riders,
which ends in the chunk's one synchronize and fetch; the faces stage;
row assembly; tagging; saving); the profiled run also the device's busy
time (its kernels' and copies' times, one stream) as a share of its wall
time, and the kernels that take most of it. Then the same three runs of
the 24gb scan with the full-width tagger registered (built on first use),
over phase 6's subset, with the tagger's host time.
"""

import contextlib
import importlib.util
import io
import json
import os
import sqlite3
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from facet_tpu_torch.models.clip import CLIPVisionConfig
from facet_tpu_torch.ops import (
    attention, cuda_build, entropy, flash_attention, fused_stats, gray_stats, softmax)
from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.stats import ENTROPY_IMPLS, batch_stats

# Kernel 2 against its twin, two limits. The two-pass design rounds p to
# bf16 at the same point as the twin; what remains is f32 summation order,
# which now and then flips the bf16 rounding of one p. A flip of a large p
# (~0.02 at 2304 keys) times a large v (~4) moves one output by ~4e-4, so
# the largest error says little about the rounding points: ATTN_TOL, half
# the 2e-3 bound tests/test_pallas_attn.py pins for the TPU kernel, only
# catches gross faults. The error's RMS relative to the output's RMS sees
# every element: about 2.5e-5 for a kernel with the twin's rounding points
# and about 1.7e-3 for one that leaves p unrounded (a float64 emulation on
# the CPU at (4, 4, 9216, 2304, 64)); ATTN_REL_RMS_TOL sits between. A
# kernel that rounds exp(s - m) before dividing by l (an online softmax's
# order) is planted at batch 4 in plain PyTorch, and the limit must reject it.
ATTN_TOL = 1e-3
ATTN_REL_RMS_TOL = 3e-4
# Kernel 7 against its twin, two limits, chosen as kernel 2's were: both
# round p to bf16 after normalizing it, so what remains is f32 summation
# and exp rounding, which now and then flips one bf16 rounding; the largest
# error is held to one bf16 ulp of the output's largest magnitude, and the
# error's RMS relative to the output's to VIT_ATTN_REL_RMS_TOL, which sits
# between the sound kernel (6.1e-5 for the twin against the Pallas kernel
# on the CPU, tests/test_torch_kernels.py) and a planted variant that rounds
# p before normalizing it (3e-3 there), emulated here in plain PyTorch.
VIT_ATTN_REL_RMS_TOL = 3e-4
ROW_SUM_TOL = 1e-2
EMBEDDING_MIN_COSINE = 0.999
ENTROPY_TOL = 1e-5
SCORE_TOL = 1e-3
VIT_LAYERS = CLIPVisionConfig().layers
SCAN_SHAPES = ((1024, 1536), (768, 1024))
SCAN_COUNTS = (24, 8)
# SCRFD's per-stride reg scales for the default scan: with the fallback
# init's zeros no box has a size and no face passes min_face_size; at 4 the
# fallback detector finds a few faces of 20-600 px in most smoke photos
SCRFD_REG_SCALE = 4.0

# H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM3 bytes/s;
# dense bf16 tensor-core FLOP/s; 32-bit operations outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_OPS = 67e12
# exponentials a second on the multi-function units: 16 a clock per SM on
# 132 SMs at the 1.98 GHz boost clock
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
# 32-bit ALU operations per pixel of each statistics kernel's arithmetic
# (their histograms and sums, not the address math): kernel 1 bins and
# checks a (hue, sat) pair; kernel 5 evaluates two 3x3 stencils, a square,
# an absolute value and three sums, and from RGB also the gray (three
# multiply-adds, a rounding add and a shift); kernel 4 computes gray, V, min, diff, S,
# H with its branch and fix-up, two bins and a sum
OPS_PER_PIXEL = {"hs_entropy": 4, "gray_stats": 26, "gray_stats_rgb": 32,
                 "fused_stats": 40}
# kernel 6, per score: a max, a subtraction, an exp, a sum and a division
SOFTMAX_OPS_PER_ELEMENT = 5


def bound(bytes_moved, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, launches=20, before=None):
    """Device time per call without the host's launch cost: ``launches``
    calls captured in one CUDA graph, the replay timed as cuda_median_ms
    times it, divided by ``launches``. With ``before``, each call follows a
    call of ``before`` in the graph, and the time of a graph of ``before``
    alone is taken off."""
    def replay_ms(calls):
        for call in calls:
            call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                for call in calls:
                    call()
        ms = cuda_median_ms(graph.replay) / launches
        del graph
        torch.cuda.empty_cache()
        return ms

    if before is None:
        return replay_ms([fn])
    return replay_ms([before, fn]) - replay_ms([before])


def host_ms(fn, calls=100):
    """Host time per call of ``fn``, its calls enqueued back to back with no
    synchronize between them: the launch path on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def device_split(fn, reps=10):
    """Device time per call of each kernel that ``fn`` launches, from
    torch.profiler over ``reps`` calls -> {kernel name: ms per call}."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "")
            split[name.split("(")[0]] = us / 1e3 / reps
    return split


def split_line(split):
    if not split:
        return "the profiler recorded no device time"
    return ", ".join(f"{name} {ms:.4f}" for name, ms in split.items()) + " ms"


def synthetic_photos(n, h, w, seed, degenerate=False):
    """Smooth colour fields with noise: photo-like hue/sat histograms.
    ``degenerate`` plants tests/test_pallas_fused_stats.py's pixels in the
    first image: gray (diff = 0), black (v = 0) and pure red."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = rng.uniform(0, 255, 3)
        gx, gy = rng.uniform(-0.15, 0.15, (2, 3))
        img = (base[None, None, :] + gx * xx[..., None] + gy * yy[..., None]
               + 40 * np.sin(xx[..., None] / rng.uniform(20, 200) + i)
               + rng.normal(0, 12, (h, w, 3)))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    if degenerate:
        out[0][0, 0], out[0][0, 1 % w], out[0][0, 2 % w] = 128, 0, (255, 0, 0)
    return out


# ------------------------------------------------- the stand-in processor

# Qwen2.5-VL-7B-Instruct's published processor: special-token ids, the
# image processor's smart_resize bounds (factor 28 = patch 14 x merge 2) and
# its normalization (OpenAI CLIP's mean and std)
QWEN_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
                 "<|vision_start|>": 151652, "<|vision_end|>": 151653,
                 "<|image_pad|>": 151655}
QWEN_MIN_PIXELS = 3136
QWEN_MAX_PIXELS = 12845056
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height, width, factor, min_pixels, max_pixels):
    """transformers' Qwen2-VL smart_resize: both sides multiples of factor,
    the pixel count within [min_pixels, max_pixels], the aspect kept."""
    import math

    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class StandInTokenizer:
    """Token ids without a vocabulary file: the special tokens at their ids,
    every other word or punctuation mark at a hash of it below ``n_text``;
    ``decode`` maps each text id onto a tag of ``vocabulary``, comma
    separated, so that a tagger's reply parses into tags."""

    def __init__(self, vocabulary, specials, n_text):
        self.vocabulary = list(vocabulary)
        self.specials = dict(specials)
        self.n_text = n_text
        self.eos_token_id = self.pad_token_id = self.specials["<|endoftext|>"]

    def convert_tokens_to_ids(self, token):
        return self.specials.get(token)

    def encode(self, text):
        import re
        import zlib

        ids = []
        for part in re.split(r"(<\|[a-z_]+\|>)", text):
            if part in self.specials:
                ids.append(self.specials[part])
            else:
                ids += [zlib.crc32(w.encode()) % self.n_text
                        for w in re.findall(r"\w+|[^\w\s]", part)]
        return ids

    def decode(self, ids, skip_special_tokens=True):
        return ", ".join(self.vocabulary[int(i) % len(self.vocabulary)]
                         for i in ids if int(i) < self.n_text)


class StandInProcessor:
    """The contract of transformers' Qwen2.5-VL processor without its files:
    the chat template, the image processor's smart_resize, bicubic resize,
    rescale and normalization and its cell-major patch rows (held to
    transformers' Qwen2VLImageProcessor by tests/test_torch_vlm.py), the
    image pad expanded to one token per merged cell, left padding. The
    defaults are the published model's; tests pass a tiny model's sizes."""

    def __init__(self, vocabulary, specials=QWEN_SPECIALS, n_text=QWEN_SPECIALS["<|endoftext|>"],
                 patch_size=14, merge_size=2, temporal_patch_size=2,
                 min_pixels=QWEN_MIN_PIXELS, max_pixels=QWEN_MAX_PIXELS):
        self.tokenizer = StandInTokenizer(vocabulary, specials, n_text)
        self.image_token_id = specials["<|image_pad|>"]
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.temporal_patch_size = temporal_patch_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        text = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
        for message in messages:
            text += f"<|im_start|>{message['role']}\n"
            for item in message["content"]:
                text += ("<|vision_start|><|image_pad|><|vision_end|>"
                         if item["type"] == "image" else item["text"])
            text += "<|im_end|>\n"
        return text + ("<|im_start|>assistant\n" if add_generation_prompt else "")

    def preprocess(self, image):
        """PIL image -> ((grid_h * grid_w, C * T * P * P) float32 patch rows in
        cell-major order, (1, grid_h, grid_w))."""
        from PIL import Image

        arr = np.asarray(image.convert("RGB"))
        p, m, t = self.patch_size, self.merge_size, self.temporal_patch_size
        rh, rw = smart_resize(arr.shape[0], arr.shape[1], p * m, self.min_pixels,
                              self.max_pixels)
        resized = np.array(Image.fromarray(arr).resize((rw, rh), resample=Image.BICUBIC))
        x = (resized.astype(np.float64) * (1 / 255)).astype(np.float32)
        x = (x - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD, np.float32)
        x = np.repeat(x.transpose(2, 0, 1)[None], t, axis=0)        # (T, C, H, W)
        gh, gw = rh // p, rw // p
        x = x.reshape(1, t, 3, gh // m, m, p, gw // m, m, p).transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        return x.reshape(gh * gw, 3 * t * p * p), (1, gh, gw)

    def __call__(self, text, images, return_tensors="np", padding=True):
        patches, grids = zip(*(self.preprocess(image) for image in images))
        rows, pad_text = [], "<|image_pad|>"
        for prompt, (gt, gh, gw) in zip(text, grids):
            n = gt * gh * gw // self.merge_size ** 2
            rows.append(self.tokenizer.encode(prompt.replace(pad_text, pad_text * n, 1)))
        width = max(len(r) for r in rows)
        pad = self.tokenizer.pad_token_id
        ids = np.array([[pad] * (width - len(r)) + r for r in rows], np.int64)
        mask = np.array([[0] * (width - len(r)) + [1] * len(r) for r in rows], np.int64)
        return {"input_ids": ids, "attention_mask": mask,
                "pixel_values": np.concatenate(patches), "image_grid_thw": np.array(grids)}


# ------------------------------------------------------------------ phases


def phase_device():
    if not torch.cuda.is_available():
        phase("device", "torch.cuda.is_available() is false: this smoke test "
                        "needs an NVIDIA GPU")
        sys.exit(1)
    line = gpu_line()
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
                    f" | nvidia-smi: {line} | torch {torch.__version__}"
                    f" cuda {torch.version.cuda}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("PIL", "cv2", "psutil", "transformers", "jax")}
    phase("device", f"host packages importable: {found} (jax is not used)")
    return line


def phase_build():
    t0 = time.time()
    cuda_build.library()
    info = cuda_build.build_info
    phase("build", f"{info['path']} built in {info['seconds']:.1f} s "
                   f"({time.time() - t0:.1f} s with load)")
    for ln in info["log"].splitlines():
        if any(word in ln for word in ("entry function", "registers", "spill", "wgmma")):
            phase("build", ln.strip())


def stats_batch(b, h, w, seed):
    """(B, H, W, 3) uint8 on the card, with the degenerate pixels."""
    return torch.from_numpy(np.stack(synthetic_photos(b, h, w, seed, True))).cuda()


# one camera photo above 16 MP (24 MP): every stats kernel counts past 2^24
# pixels of one image there, where an f32 counter stops counting
BIG_PHOTO = (4000, 6000)
BIG_KINDS = ("near-uniform", "noisy")


def big_photo(kind, seed=24):
    """(1, 4000, 6000, 3) uint8 on the card. "near-uniform": one colour,
    with every 997th pixel drawn at random (one gray bin holds nearly all
    24 M pixels); "noisy": every channel drawn uniformly."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (1, *BIG_PHOTO, 3)
    noise = torch.randint(0, 256, shape, generator=g, device="cuda", dtype=torch.uint8)
    if kind == "noisy":
        return noise
    rgb = torch.tensor([90, 140, 200], dtype=torch.uint8, device="cuda").expand(shape)
    rgb = rgb.contiguous()
    flat, flat_noise = rgb.view(-1, 3), noise.view(-1, 3)
    flat[::997] = flat_noise[::997]
    return rgb


def check_entropy(gpu):
    """Kernel 1 vs its twin: the scan's own batches (the reported time is
    the first), the fast tier's stride 4, an odd h*w, an image whose
    pixels all fall into one bin, and the scan's batch with hue and
    saturation drawn uniformly, every bin filled (timed in a CUDA graph
    too: the most histogram traffic), and one 24 MP photo near-uniform and
    one noisy (BIG_KINDS); exact histograms. At the first shape two
    more calls must return bit-identical entropy, and the kernel is also
    timed in a CUDA graph, with its device time split by launch (profiler).
    Its bound: the int32 hue and saturation it reads, 8 B per counted
    pixel."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w, 1) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)]
    cases += [(16, 1024, 1536, 1), (16, 1024, 1536, 4), (3, 37, 53, 1),
              (3, 37, 53, 4), ("one bin", 2, 37, 53, 1),
              ("uniform", SCAN_COUNTS[0], *SCAN_SHAPES[0], 1)]
    cases += [(kind, 1, *BIG_PHOTO, 1) for kind in BIG_KINDS]
    for case in cases:
        kind = case[0] if isinstance(case[0], str) else ""
        b, h, w, stride = case[1:] if kind else case
        if kind == "one bin":    # every pixel in one bin: entropy 0
            hue = torch.full((b, h * w), 17, dtype=torch.int32, device="cuda")
            sat = torch.full((b, h * w), 201, dtype=torch.int32, device="cuda")
        elif kind == "uniform":  # every bin filled: the most histogram traffic
            g = torch.Generator(device="cuda").manual_seed(180)
            hue = torch.randint(0, 180, (b, h * w), generator=g, device="cuda",
                                dtype=torch.int32)
            sat = torch.randint(0, 256, (b, h * w), generator=g, device="cuda",
                                dtype=torch.int32)
        else:
            if kind in BIG_KINDS:
                rgb = big_photo(kind)
            else:
                rgb = torch.from_numpy(
                    np.stack(synthetic_photos(b, h, w, seed=h + stride))).cuda()
            hh, ss, _ = rgb_to_hsv(rgb)
            hue = hh.reshape(b, -1).contiguous()
            sat = ss.reshape(b, -1).contiguous()
        got, hist = entropy.hs_entropy_with_histogram(hue, sat, stride)
        want = entropy.hs_entropy_plain(hue, sat, stride)
        want_hist = entropy.hs_histogram_plain(hue, sat, stride)
        torch.cuda.synchronize()
        if not torch.equal(hist, want_hist):
            raise AssertionError(f"entropy histogram differs at {(b, h, w, stride)}")
        err = float((got - want).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"entropy err {err} > {ENTROPY_TOL} at "
                                 f"{(b, h, w, stride)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: entropy.hs_entropy(hue, sat, stride))
        plain_ms = cuda_median_ms(lambda: entropy.hs_entropy_plain(hue, sat, stride))
        n_eff = b * -(-h * w // stride)
        bound_ms, bound_by = bound(n_eff * 8 + b * 4,
                                   n_eff * OPS_PER_PIXEL["hs_entropy"], FP32_OPS)
        extra = ""
        if kind == "uniform":
            extra = (f"; in a CUDA graph "
                     f"{graph_ms(lambda: entropy.hs_entropy(hue, sat, stride)):.4f} ms")
        if "ms" not in report:
            again = [entropy.hs_entropy(hue, sat, stride) for _ in range(2)]
            if not all(torch.equal(x, got) for x in again):
                raise AssertionError("hs_entropy is not bit-identical across calls "
                                     f"at {(b, h, w, stride)}")
            report["graph_ms"] = graph_ms(lambda: entropy.hs_entropy(hue, sat, stride))
            split = device_split(lambda: entropy.hs_entropy(hue, sat, stride))
            host = host_ms(lambda: entropy.hs_entropy(hue, sat, stride))
            extra = (f"; bit-identical over three calls; host launch path per call "
                     f"{host * 1e3:.1f} us; in a CUDA graph "
                     f"{report['graph_ms']:.4f} ms ({bound_ms / report['graph_ms']:.0%} "
                     f"of its bound); device time by launch: {split_line(split)}")
        phase("kernels", f"hs_entropy {kind + ' ' if kind else ''}B={b} {h}x{w} "
                         f"stride={stride}: histogram "
                         f"exact, max|d entropy|={err:.3g}, kernel {ms:.4f} ms, "
                         f"twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}){extra} ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_entropy_fixed(gpu):
    """Kernel 3 (kernel 1 with n_valid) vs its twin at the scan's batches
    and an odd h*w, with -1 hue markers on the last tenth of each image
    that count in n_valid but land in no bin."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)] + [(3, 37, 53)]
    for b, h, w in cases:
        rgb = stats_batch(b, h, w, seed=h + 3)
        hh, ss, _ = rgb_to_hsv(rgb)
        hue = hh.reshape(b, -1).contiguous()
        sat = ss.reshape(b, -1).contiguous()
        hue[:, -(h * w // 10):] = -1
        n_valid = h * w
        got = entropy.hs_entropy(hue, sat, n_valid=n_valid)
        want = entropy.hs_entropy_plain(hue, sat, n_valid=n_valid)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"fixed-denominator entropy err {err} > "
                                 f"{ENTROPY_TOL} at {(b, h, w)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: entropy.hs_entropy(hue, sat, n_valid=n_valid))
        plain_ms = cuda_median_ms(
            lambda: entropy.hs_entropy_plain(hue, sat, n_valid=n_valid))
        bound_ms, bound_by = bound(b * h * w * 8 + b * 4,
                                   b * h * w * OPS_PER_PIXEL["hs_entropy"], FP32_OPS)
        extra = ""
        if "ms" not in report:
            report["graph_ms"] = graph_ms(
                lambda: entropy.hs_entropy(hue, sat, n_valid=n_valid))
            extra = f"; in a CUDA graph {report['graph_ms']:.4f} ms"
        phase("kernels", f"hs_entropy n_valid B={b} {h}x{w}: max|d entropy|="
                         f"{err:.3g}, kernel {ms:.4f} ms, twin {plain_ms:.3f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by}){extra} ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_fused_stats(gpu):
    """Kernel 4 vs its twin at the scan's batches and at (3, 37, 53), where
    h*w is odd and not a multiple of 4, and at one 24 MP photo near-uniform
    and one noisy (BIG_KINDS): identical gray histograms and saturation
    pairs, entropy within ENTROPY_TOL. Its bound: the uint8 RGB read once,
    and the outputs. At the first shape it is also timed in a CUDA graph
    on hue and saturation that fill every bin (uniformly drawn RGB)."""
    report = {"max_abs_err": 0.0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)] + [(3, 37, 53)]
    cases += [(kind, 1, *BIG_PHOTO) for kind in BIG_KINDS]
    for case in cases:
        kind = case[0] if isinstance(case[0], str) else ""
        b, h, w = case[1:] if kind else case
        rgb = big_photo(kind) if kind else stats_batch(b, h, w, seed=h + 4)
        got = fused_stats.fused_stats(rgb)
        want = fused_stats.fused_stats_plain(rgb)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"fused_stats histogram or saturation differs at "
                                 f"{(b, h, w)}")
        err = float((got[0] - want[0]).abs().max())
        if err > ENTROPY_TOL:
            raise AssertionError(f"fused_stats entropy err {err} > {ENTROPY_TOL} "
                                 f"at {(b, h, w)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: fused_stats.fused_stats(rgb))
        plain_ms = cuda_median_ms(lambda: fused_stats.fused_stats_plain(rgb))
        bound_ms, bound_by = bound(b * h * w * 3 + b * (4 + 256 * 4 + 16),
                                   b * h * w * OPS_PER_PIXEL["fused_stats"], FP32_OPS)
        extra = ""
        if "ms" not in report:
            report["graph_ms"] = graph_ms(lambda: fused_stats.fused_stats(rgb))
            split = device_split(lambda: fused_stats.fused_stats(rgb))
            g = torch.Generator(device="cuda").manual_seed(4)
            noisy = torch.randint(0, 256, rgb.shape, generator=g, device="cuda",
                                  dtype=torch.uint8)
            noisy_ms = graph_ms(lambda: fused_stats.fused_stats(noisy))
            del noisy
            extra = (f"; in a CUDA graph {report['graph_ms']:.4f} ms "
                     f"({bound_ms / report['graph_ms']:.0%} of its bound), on "
                     f"uniformly drawn RGB {noisy_ms:.4f} ms; device "
                     f"time by launch: {split_line(split)}")
        phase("kernels", f"fused_stats {kind + ' ' if kind else ''}B={b} {h}x{w}: "
                         f"histogram and saturation "
                         f"exact, max|d entropy|={err:.3g}, kernel {ms:.4f} ms, "
                         f"twin {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}){extra} ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def check_gray_stats(gpu):
    """Kernel 5 vs its twin, through both entries: fused_gray_stats_rgb(rgb)
    (the main path's, from the uint8 RGB) and fused_gray_stats(gray) (an
    int32 gray plane), at the scan's batches, at (2, 3, 3), the smallest
    image the engine takes, (3, 37, 53), and one 24 MP photo near-uniform
    and one noisy (BIG_KINDS): every output identical to
    fused_gray_stats_plain(rgb_to_gray(rgb)). The reported time is the main
    path's call in the tree under test: fused_gray_stats_rgb(rgb) where the
    tree has it, else fused_gray_stats(rgb_to_gray(rgb)), so that --ab holds
    two trees to the same work. Its bound: the uint8 RGB read once, and the
    outputs. At the first shape it also reports the main path's call in a
    CUDA graph with its device time by launch, the gray entry alone, and
    rgb_to_gray alone (events and graph)."""
    rgb_entry = getattr(gray_stats, "fused_gray_stats_rgb", None)

    def main_call(rgb):
        if rgb_entry is not None:
            return rgb_entry(rgb)
        return gray_stats.fused_gray_stats(rgb_to_gray(rgb))

    report = {"max_abs_err": 0}
    cases = [(n, h, w) for (h, w), n in zip(SCAN_SHAPES, SCAN_COUNTS)]
    cases += [(2, 3, 3), (3, 37, 53)]
    cases += [(kind, 1, *BIG_PHOTO) for kind in BIG_KINDS]
    for case in cases:
        kind = case[0] if isinstance(case[0], str) else ""
        b, h, w = case[1:] if kind else case
        rgb = big_photo(kind) if kind else stats_batch(b, h, w, seed=h + 5)
        gray = rgb_to_gray(rgb).contiguous()
        want = gray_stats.fused_gray_stats_plain(gray)
        entries = {"gray": gray_stats.fused_gray_stats(gray)}
        if rgb_entry is not None:
            entries["rgb"] = rgb_entry(rgb)
        torch.cuda.synchronize()
        for entry, got in entries.items():
            for name, g, x in zip(("hist", "lap_sum", "lap_sumsq", "imm_abs"), got, want):
                if not torch.equal(g, x):
                    raise AssertionError(f"gray_stats ({entry} entry) {name} differs "
                                         f"at {kind or (b, h, w)}")
        ms = cuda_median_ms(lambda: main_call(rgb))
        plain_ms = cuda_median_ms(
            lambda: gray_stats.fused_gray_stats_plain(rgb_to_gray(rgb)))
        outputs = b * (256 * 4 + 3 * 8)
        bound_ms, bound_by = bound(b * h * w * 3 + outputs,
                                   b * h * w * OPS_PER_PIXEL["gray_stats_rgb"], FP32_OPS)
        extra = ""
        if "ms" not in report:
            report["graph_ms"] = graph_ms(lambda: main_call(rgb))
            split = device_split(lambda: main_call(rgb))
            gray_graph = graph_ms(lambda: gray_stats.fused_gray_stats(gray))
            gray_split = device_split(lambda: gray_stats.fused_gray_stats(gray))
            gray_bound, _ = bound(b * h * w * 4 + outputs,
                                  b * h * w * OPS_PER_PIXEL["gray_stats"], FP32_OPS)
            conv_ms = cuda_median_ms(lambda: rgb_to_gray(rgb))
            conv_graph = graph_ms(lambda: rgb_to_gray(rgb))
            conv_bound, _ = bound(b * h * w * (3 + 4), 0, FP32_OPS)
            extra = (f"; in a CUDA graph {report['graph_ms']:.4f} ms "
                     f"({bound_ms / report['graph_ms']:.0%} of its bound), device time "
                     f"by launch: {split_line(split)}; the gray entry alone: in a CUDA "
                     f"graph {gray_graph:.4f} ms (bound {gray_bound:.4f} ms), by launch "
                     f"{split_line(gray_split)}; rgb_to_gray alone: {conv_ms:.4f} ms, in "
                     f"a CUDA graph {conv_graph:.4f} ms (bound {conv_bound:.4f} ms)")
        phase("kernels", f"gray_stats {kind + ' ' if kind else ''}B={b} {h}x{w}: every "
                         f"output of {' and '.join(entries)} entries exact, main path call "
                         f"{'fused_gray_stats_rgb' if rgb_entry else 'fused_gray_stats(rgb_to_gray)'}"
                         f" {ms:.4f} ms, twin {plain_ms:.3f} ms, bound "
                         f"{bound_ms:.4f} ms ({bound_by}){extra} ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return report


def attention_errors(got, want):
    """(max |got - want|, RMS of got - want over the RMS of want)."""
    diff = (got - want).double()
    return (float(diff.abs().max()),
            float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()))


def cross_round_then_normalize(q, k, v):
    """The planted variant of kernel 2's rounding points: exp(s - m)
    rounded to bf16 before it is divided by l (what a one-pass online
    softmax does), in plain PyTorch."""
    qb, kb, vb = (x.to(torch.bfloat16).float() for x in (q, k, v))
    with full_float32():
        s = torch.matmul(qb, kb.transpose(-1, -2))
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return torch.matmul(e.to(torch.bfloat16).float(), vb) / e.sum(dim=-1, keepdim=True)


def check_attention(gpu):
    """Kernel 2 vs its twin: TOPIQ's C2 level at 384 px for the scan's own
    batches (the reported time is the first), then batch 4 at 384 px and at
    the fast tier's 256 px, where the planted variant must fail the
    relative-RMS limit. Its bound: 4*B*H*Nq*Nk*D bf16 tensor-core FLOP (QK^T
    and PV) against q, k, v and out in f32 read or written once; its
    library yardstick: F.scaled_dot_product_attention on q, k, v in bf16."""
    report = {"max_abs_err": 0.0}
    cases = [(n, 4, 9216, 2304) for n in SCAN_COUNTS]
    cases += [(4, 4, 9216, 2304), (4, 4, 4096, 1024)]
    for b, h, nq, nk in cases:
        g = torch.Generator(device="cuda").manual_seed(nq)
        q = torch.randn((b, h, nq, 64), generator=g, device="cuda") / 8.0
        k = torch.randn((b, h, nk, 64), generator=g, device="cuda")
        v = torch.randn((b, h, nk, 64), generator=g, device="cuda")
        got = attention.cross_attention(q, k, v)
        want = attention.cross_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("cross_attention produced non-finite values")
        err, rel_rms = attention_errors(got, want)
        if err > ATTN_TOL or rel_rms > ATTN_REL_RMS_TOL:
            raise AssertionError(
                f"attention max|d| {err} (tol {ATTN_TOL}), relative RMS "
                f"{rel_rms} (tol {ATTN_REL_RMS_TOL}) at {(b, h, nq, nk)}")
        planted = ""
        if b == 4:
            _, planted_rms = attention_errors(cross_round_then_normalize(q, k, v), want)
            if planted_rms <= ATTN_REL_RMS_TOL:
                raise AssertionError(f"the relative RMS limit does not reject the "
                                     f"planted variant ({planted_rms}) at {(b, h, nq, nk)}")
            planted = f"; planted variant {planted_rms:.3g}"
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: attention.cross_attention(q, k, v))
        plain_ms = cuda_median_ms(lambda: attention.cross_attention_plain(q, k, v))
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        library_ms = cuda_median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qb, kb, vb))
        del qb, kb, vb
        bound_ms, bound_by = bound(b * h * (2 * nq + 2 * nk) * 64 * 4,
                                   4 * b * h * nq * nk * 64, BF16_FLOPS)
        # the kernel's own floor: three products, two exponentials a score
        floor_ms = max(6 * b * h * nq * nk * 64 / BF16_FLOPS,
                       2 * b * h * nq * nk / MUFU_EXP_PER_S) * 1e3
        grid = attention.geometry(b, h, nq, nk)
        graphs = ""
        if "ms" not in report:
            report["blocks_per_sm"] = grid["blocks_per_sm"]
            report["graph_ms"] = graph_ms(lambda: attention.cross_attention(q, k, v))
            qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
            report["library_graph_ms"] = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qb, kb, vb))
            del qb, kb, vb
            graphs = (f" (in a CUDA graph: kernel {report['graph_ms']:.3f} ms, SDPA "
                      f"{report['library_graph_ms']:.3f} ms)")
        phase("kernels", f"cross_attention ({b},{h},{nq},{nk},64): "
                         f"max|d|={err:.3g} (tol {ATTN_TOL}), relative RMS "
                         f"{rel_rms:.3g} (tol {ATTN_REL_RMS_TOL}{planted}), kernel "
                         f"{ms:.3f} ms, twin {plain_ms:.3f} ms, SDPA bf16 "
                         f"{library_ms:.3f} ms{graphs}, bound {bound_ms:.4f} ms "
                         f"({bound_by}), two-pass floor {floor_ms:.3f} ms; "
                         f"{grid['blocks']} blocks, {grid['blocks_per_sm']} per SM; "
                         f"reckoned from the grid: {grid['staged_bytes'] / 1e9:.3f} GB "
                         f"staged into shared memory, {grid['l2_bytes'] / 1e9:.3f} GB "
                         f"of K/V through L2 ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del q, k, v, got, want
    return report


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|, elementwise."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


def check_softmax(gpu):
    """Kernel 6 vs its twin: the ViT's scores at the scan's batches (the
    reported time is the first), then the kernel's edge paths: (3, 3, 37,
    53) (whole row groups and a ragged last one), (1, 3, 37, 53) (fewer
    rows than a group), rows of 1024 (the widest it takes) and of 1, and
    (2, 16, 257, 257) at a base 2 bytes off a 16-byte boundary ("offset");
    bf16 at the ViT's scale (x4, as tests/test_pallas_softmax.py makes
    them). Every element within one bf16 ulp of the twin, row sums within
    ROW_SUM_TOL. Its bound: the scores read once and the probabilities
    written once; its library yardstick: torch.softmax on the same bf16
    tensor. At the first shape both are also timed in a CUDA graph, as they
    are (the 50.7 MB input last read one call before, with the 50.7 MB
    output written since) and right after the input is written anew, as
    the ViT's QK^T product leaves it."""
    report = {"max_abs_err": 0.0}
    cases = [(n, 16, 257, 257) for n in SCAN_COUNTS]
    cases += [(3, 3, 37, 53), (1, 3, 37, 53), (2, 2, 9, 1024), (1, 2, 5, 1),
              ("offset", 2, 16, 257, 257)]
    for case in cases:
        offset = case[0] == "offset"
        shape = case[1:] if offset else case
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        s = (torch.randn(shape, generator=g, device="cuda") * 4.0).to(torch.bfloat16)
        if offset:
            s = torch.cat([s.new_zeros(1), s.reshape(-1)])[1:].view(shape)
        got = softmax.softmax(s).float()
        want = softmax.softmax_plain(s).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if not (diff <= bf16_ulp(torch.maximum(got.abs(), want.abs()))).all():
            raise AssertionError(f"softmax differs by more than one bf16 ulp at {shape}")
        row_err = float((got.sum(-1) - 1.0).abs().max())
        if row_err > ROW_SUM_TOL:
            raise AssertionError(f"softmax row sums off by {row_err} at {shape}")
        err = float(diff.max())
        n_diff = int((diff > 0).sum())
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: softmax.softmax(s))
        plain_ms = cuda_median_ms(lambda: softmax.softmax_plain(s))
        library_ms = cuda_median_ms(lambda: torch.softmax(s, dim=-1))
        bound_ms, bound_by = bound(s.numel() * 2 * 2,
                                   s.numel() * SOFTMAX_OPS_PER_ELEMENT, FP32_OPS)
        graphs = ""
        if "ms" not in report:
            report["graph_ms"] = graph_ms(lambda: softmax.softmax(s))
            report["library_graph_ms"] = graph_ms(lambda: torch.softmax(s, dim=-1))
            fresh = s.clone()

            def write():
                fresh.copy_(s)

            warm = graph_ms(lambda: softmax.softmax(fresh), before=write)
            library_warm = graph_ms(lambda: torch.softmax(fresh, dim=-1), before=write)
            host = (host_ms(lambda: softmax.softmax(s)),
                    host_ms(lambda: torch.softmax(s, dim=-1)))
            graphs = (f"; host launch path per call: kernel {host[0] * 1e3:.1f} us, "
                      f"torch.softmax {host[1] * 1e3:.1f} us"
                      f"; in a CUDA graph: kernel {report['graph_ms']:.4f} ms, "
                      f"torch.softmax {report['library_graph_ms']:.4f} ms (kernel "
                      f"{report['graph_ms'] / report['library_graph_ms']:.2f}x "
                      f"torch.softmax, {bound_ms / report['graph_ms']:.0%} of its "
                      f"bound); right after its input is written: kernel "
                      f"{warm:.4f} ms, torch.softmax {library_warm:.4f} ms")
            del fresh
        phase("kernels", f"softmax {'offset ' if offset else ''}{shape}: within one "
                         f"bf16 ulp, {n_diff} of {s.numel()} elements differ, "
                         f"max|d|={err:.3g}, max|row sum - 1|={row_err:.3g}, kernel "
                         f"{ms:.4f} ms, twin {plain_ms:.3f} ms, torch.softmax "
                         f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}){graphs} ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del s, got, want, diff
    return report


def round_then_normalize(q, k, v, scale):
    """The planted variant of kernel 7's rounding points: p rounded to bf16
    before it is normalized (the order of the TPU kernel's multi-block
    schedule), in plain PyTorch."""
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k, v))
    with full_float32():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out = torch.matmul(e.to(torch.bfloat16).float(), vf) / e.sum(dim=-1, keepdim=True)
    return out.to(q.dtype).transpose(1, 2)


def check_vit_attention(gpu):
    """Kernel 7 vs its twin: the ViT's (B, 257, 16, 64) at the scan's
    batches (the reported time is the first), then 37 tokens (one partial
    tile), 65 (one row past a tile) and 400 (the longest the kernel takes). Its bound: q, k, v and out in bf16 read or
    written once against 4*B*H*S*S*D bf16 tensor-core FLOP; its library
    yardstick: F.scaled_dot_product_attention on the same bf16 tensors in
    (B, H, S, D) with the same scale."""
    report = {"max_abs_err": 0.0}
    cases = [(n, 257, 16, 64) for n in SCAN_COUNTS]
    cases += [(2, 37, 16, 64), (2, 65, 16, 64), (2, 400, 16, 64)]
    scale = 64 ** -0.5
    for b, s, h, d in cases:
        g = torch.Generator(device="cuda").manual_seed(b * s)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = flash_attention.flash_attention(q, k, v, scale)
        want = flash_attention.flash_attention_plain(q, k, v, scale)
        planted = round_then_normalize(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError("flash_attention produced non-finite values")
        err, rel_rms = attention_errors(got.float(), want.float())
        _, planted_rms = attention_errors(planted.float(), want.float())
        limit = float(bf16_ulp(want.float().abs().max()))
        if err > limit or rel_rms > VIT_ATTN_REL_RMS_TOL:
            raise AssertionError(
                f"flash_attention max|d| {err} (limit {limit}), relative RMS "
                f"{rel_rms} (limit {VIT_ATTN_REL_RMS_TOL}) at {(b, s, h, d)}")
        if planted_rms <= VIT_ATTN_REL_RMS_TOL:
            raise AssertionError(f"the relative RMS limit does not reject the planted "
                                 f"variant ({planted_rms}) at {(b, s, h, d)}")
        report["max_abs_err"] = max(report["max_abs_err"], err)
        ms = cuda_median_ms(lambda: flash_attention.flash_attention(q, k, v, scale))
        plain_ms = cuda_median_ms(
            lambda: flash_attention.flash_attention_plain(q, k, v, scale))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                     scale=scale))
        bound_ms, bound_by = bound(4 * b * s * h * d * 2, 4 * b * h * s * s * d, BF16_FLOPS)
        grid = flash_attention.geometry(b, s, h)
        graphs = ""
        if "ms" not in report:
            report["blocks_per_sm"] = grid["blocks_per_sm"]
            report["graph_ms"] = graph_ms(
                lambda: flash_attention.flash_attention(q, k, v, scale))
            report["library_graph_ms"] = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                         scale=scale))
            graphs = (f" (in a CUDA graph: kernel {report['graph_ms']:.4f} ms, SDPA "
                      f"{report['library_graph_ms']:.4f} ms)")
        phase("kernels", f"flash_attention ({b},{s},{h},{d}): max|d|={err:.3g} "
                         f"(limit {limit:.3g}), relative RMS {rel_rms:.3g} (limit "
                         f"{VIT_ATTN_REL_RMS_TOL}; planted variant {planted_rms:.3g}), "
                         f"kernel {ms:.4f} ms, twin {plain_ms:.3f} ms, SDPA bf16 "
                         f"{library_ms:.4f} ms{graphs}, bound {bound_ms:.4f} ms ({bound_by}); "
                         f"{grid['blocks']} blocks, {grid['blocks_per_sm']} per SM; "
                         f"reckoned from the grid: {grid['staged_bytes'] / 1e6:.1f} MB "
                         f"staged into shared memory ({gpu})")
        if "ms" not in report:
            report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del q, k, v, qt, kt, vt, got, want, planted
    return report


def check_prepass(gpu):
    """The whole statistics prepass (ops/stats.py:batch_stats) in both
    configurations at the scan's batches, as the fused pass calls it: the
    layer the stats kernels serve, kernels and plain ops together. CUDA
    events at every shape; at the first also a CUDA graph and the device
    time by launch (the profiler's ten largest), which names the ops that
    take the prepass's time. Not a kernel: it adds nothing to the report."""
    for first, ((h, w), b) in zip((True, False), zip(SCAN_SHAPES, SCAN_COUNTS)):
        rgb = stats_batch(b, h, w, seed=h + 6)
        for impl in ENTROPY_IMPLS:
            def call(impl=impl):
                return batch_stats(rgb, 1, impl)

            ms = cuda_median_ms(call)
            extra = ""
            if first:
                split = device_split(call)
                top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:10])
                extra = (f"; in a CUDA graph {graph_ms(call):.4f} ms; device time by "
                         f"launch, {sum(split.values()):.4f} ms in {len(split)} "
                         f"kernels, the largest: {split_line(top)}")
            phase("prepass", f"stats prepass {impl} B={b} {h}x{w}: {ms:.3f} ms"
                             f"{extra} ({gpu})")
    return {}


def time_vit(gpu):
    """The ViT-L/14 forward (bf16, random weights from the fallback init)
    at the scan's batch of 24, and one of its 24 attention layers alone
    (projections included, on a (24, 257, 1024) bf16 input), under each
    attention schedule, timed in turns (xla, psoftmax, flash, then back):
    the layer that kernels 6 and 7 serve."""
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models.clip import ATTN_IMPLS, CLIPVisionTower

    config = CLIPVisionConfig()
    tower = CLIPVisionTower(config, torch.bfloat16)
    P.fallback_init(tower, seed=0)
    tower = tower.cuda().eval()
    b = SCAN_COUNTS[0]
    g = torch.Generator(device="cuda").manual_seed(224)
    x = torch.randn((b, config.image_size, config.image_size, 3), generator=g,
                    device="cuda")
    y = torch.randn((b, config.seq_len, config.width), generator=g,
                    device="cuda").to(torch.bfloat16)
    attn = tower.blocks[0].attn
    forward = {impl: [] for impl in ATTN_IMPLS}
    layer = {impl: [] for impl in ATTN_IMPLS}
    with torch.no_grad():
        for impl in ATTN_IMPLS + ATTN_IMPLS[::-1]:
            forward[impl].append(cuda_median_ms(lambda: tower(x, impl)))
            layer[impl].append(cuda_median_ms(lambda: attn(y, impl)))
    for impl in ATTN_IMPLS:
        share = config.layers * np.mean(layer[impl]) / np.mean(forward[impl])
        phase("kernels", f"ViT-L/14 B={b} {impl}: forward " + " / ".join(
            f"{ms:.3f}" for ms in forward[impl]) + " ms, one attention layer " +
            " / ".join(f"{ms:.4f}" for ms in layer[impl]) + f" ms (x{config.layers}: "
            f"{share:.1%} of the forward) ({gpu})")
    del tower, x, y, attn


def phase_kernels(gpu):
    report = {"hs_entropy": check_entropy(gpu),
              "hs_entropy_fixed": check_entropy_fixed(gpu),
              "fused_stats": check_fused_stats(gpu),
              "gray_stats": check_gray_stats(gpu),
              "cross_attention": check_attention(gpu),
              "softmax": check_softmax(gpu),
              "flash_attention": check_vit_attention(gpu)}
    check_prepass(gpu)
    time_vit(gpu)
    torch.cuda.empty_cache()       # the rider sizes its slices from free memory
    return report


def write_photos(directory):
    from PIL import Image

    paths = []
    for (h, w), count in zip(SCAN_SHAPES, SCAN_COUNTS):
        for i, img in enumerate(synthetic_photos(count, h, w, seed=h * 7)):
            path = os.path.join(directory, f"photo_{h}x{w}_{i:02d}.jpg")
            Image.fromarray(img).save(path, quality=92)
            paths.append(path)
    return paths


# every launch counter the scans read: name -> (wrapper, attribute); kernel
# 5 launches from the RGB on the main path ("gray_stats"), never from a gray
# plane ("gray_stats_plane"). (--ab imports this file in trees from before
# the RGB entry, which never scan.)
COUNTERS = {"hs_entropy": (entropy.hs_entropy, "launches"),
            "hs_entropy_fixed": (entropy.hs_entropy, "launches_fixed"),
            "fused_stats": (fused_stats.fused_stats, "launches"),
            "gray_stats": (getattr(gray_stats, "fused_gray_stats_rgb",
                                   gray_stats.fused_gray_stats), "launches"),
            "gray_stats_plane": (gray_stats.fused_gray_stats, "launches"),
            "cross_attention": (attention.cross_attention, "launches"),
            "softmax": (softmax.softmax, "launches"),
            "flash_attention": (flash_attention.flash_attention, "launches")}
# the scans, in order: name -> (environment, kernels the scan must launch,
# kernels it must not); kernels 6 and 7 launch in their own scan only, once
# per ViT layer per forward
_VIT_ATTENTION = {"softmax", "flash_attention"}
SCANS = {
    "pallas": ({"FACET_ENTROPY_IMPL": "pallas"},
               {"hs_entropy", "gray_stats", "cross_attention"},
               {"fused_stats", "gray_stats_plane"} | _VIT_ATTENTION),
    "pallas_fused": ({"FACET_ENTROPY_IMPL": "pallas_fused"},
                     {"fused_stats", "gray_stats", "cross_attention"},
                     {"hs_entropy", "gray_stats_plane"} | _VIT_ATTENTION),
    "psoftmax": ({"FACET_ENTROPY_IMPL": "pallas", "FACET_ATTN_IMPL": "psoftmax"},
                 {"hs_entropy", "gray_stats", "cross_attention", "softmax"},
                 {"fused_stats", "gray_stats_plane", "flash_attention"}),
    "flash": ({"FACET_ENTROPY_IMPL": "pallas", "FACET_ATTN_IMPL": "flash"},
              {"hs_entropy", "gray_stats", "cross_attention", "flash_attention"},
              {"fused_stats", "gray_stats_plane", "softmax"}),
}
ROW_COLUMNS = ("path", "aesthetic", "topiq_score", "quality_score", "phash",
               "raw_color_entropy", "color_score", "aggregate", "scoring_model",
               "histogram_data", "histogram_spread", "mean_luminance",
               "histogram_bimodality", "exposure_score", "shadow_clipped",
               "highlight_clipped", "is_silhouette", "raw_sharpness_variance",
               "tech_sharpness", "noise_sigma", "mean_saturation", "is_monochrome",
               "contrast_score", "dynamic_range_stops", "clip_embedding", "tags")
# columns the two stats configurations must write identically: the pHash
# and everything derived from the integer statistics alone
EXACT_COLUMNS = ("phash", "histogram_data", "histogram_spread", "mean_luminance",
                 "histogram_bimodality", "exposure_score", "shadow_clipped",
                 "highlight_clipped", "is_silhouette", "raw_sharpness_variance",
                 "tech_sharpness", "noise_sigma", "mean_saturation", "is_monochrome",
                 "contrast_score", "dynamic_range_stops")
SCORE_COLUMNS = ("aesthetic", "topiq_score", "quality_score", "color_score", "aggregate")
# scores the ViT does not feed in a --pass quality scan: TOPIQ's
TOPIQ_COLUMNS = ("aesthetic", "topiq_score", "quality_score")


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def run_scan(photo_dir, db, cfg, impl, gpu):
    """One --pass quality scan in the environment SCANS[impl] -> (rows,
    launches). Counts are zeroed just before and read just after."""
    from facet_tpu_torch.__main__ import main as cli_main
    from facet_tpu_torch.models.topiq import TOPIQNet

    env, must, must_not = SCANS[impl]
    in_topiq = []     # the flags as TOPIQ's forward sees them, during the scan
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, _: in_topiq.append(tf32_flags())
        if isinstance(module, TOPIQNet) else None)
    os.environ.update(env)
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli_main([photo_dir, "--pass", "quality", "--db", db, "--config", cfg])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
    hook.remove()
    for key in env:
        del os.environ[key]
    if rc != 0:
        raise AssertionError(f"scan ({impl}) exited {rc}")
    conn = sqlite3.connect(db)
    rows = [dict(zip(ROW_COLUMNS, r)) for r in conn.execute(
        f"SELECT {', '.join(ROW_COLUMNS)} FROM photos ORDER BY path")]
    conn.close()
    for row in rows:
        if any(row[c] is None for c in ("aesthetic", "topiq_score", "phash",
                                        "raw_color_entropy", "aggregate",
                                        "clip_embedding")):
            raise AssertionError(f"null column in row {row['path']} ({impl})")
        if row["scoring_model"] != "topiq":
            raise AssertionError(f"row scored by {row['scoring_model']!r}, not "
                                 f"topiq: {row['path']} ({impl})")
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched during the {impl} scan")
        if name in _VIT_ATTENTION and launches[name] % VIT_LAYERS:
            raise AssertionError(f"kernel {name} launched {launches[name]} times during "
                                 f"the {impl} scan, not a multiple of {VIT_LAYERS}")
    for name in must_not:
        if launches[name] != 0:
            raise AssertionError(f"kernel {name} launched {launches[name]} times "
                                 f"during the {impl} scan")
    if not in_topiq or any(any(flags) for flags in in_topiq):
        raise AssertionError(f"TOPIQ's forward ran with TF32 flags {in_topiq} "
                             f"({impl}); it must run in full float32")
    phase("scan", f"{impl}: TF32 flags (cudnn, matmul) inside TOPIQ's "
                  f"{len(in_topiq)} forwards: {sorted(set(in_topiq))}; after the "
                  f"scan: {tf32_flags()}")
    phase("scan", f"{impl}: {len(rows)} rows complete; kernel launches during "
                  f"the scan {launches}; {len(rows) / seconds:.2f} images/s end "
                  f"to end ({seconds:.1f} s, {gpu})")
    return rows, launches


# the default multi-pass scan: its photos columns, the ones SAMP-Net and
# the faces member write, and the float32 networks whose TF32 flags are read
DEFAULT_COLUMNS = ROW_COLUMNS + (
    "comp_score", "power_point_score", "composition_pattern", "leading_lines_score",
    "face_count", "face_quality", "eye_sharpness", "face_sharpness", "face_ratio",
    "face_confidence", "raw_eye_sharpness", "is_blink", "is_group_portrait")
FACE_FLOATS = ("face_quality", "eye_sharpness", "face_sharpness", "face_ratio",
               "face_confidence", "raw_eye_sharpness")
DEFAULT_MUST = {"hs_entropy", "gray_stats", "cross_attention"}


def set_scrfd_reg_scale(scale):
    """Every FacePipeline.create from here on sets SCRFD's reg scales."""
    from facet_tpu_torch.models.face_pipeline import FacePipeline

    create = FacePipeline.create.__func__

    def create_scaled(cls, config, cached, device):
        pipeline = create(cls, config, cached, device)
        with torch.no_grad():
            for s in pipeline.detector.head.scales:
                s.fill_(scale)
        return pipeline

    FacePipeline.create = classmethod(create_scaled)


class Tee(io.StringIO):
    """Keeps what is written and passes it on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def run_default_scan(photo_dir, db, quality_rows, gpu):
    """The default multi-pass scan under the "16gb" profile, checked as the
    docstring says -> (launches, faces found in the 1024x1536 photos)."""
    from facet_tpu_torch.__main__ import main as cli_main
    from facet_tpu_torch.config.default_config import write_default_config
    from facet_tpu_torch.models.face_models import IResNet, LandmarkNet
    from facet_tpu_torch.models.samp_net import SAMPNet
    from facet_tpu_torch.models.scrfd import SCRFD
    from facet_tpu_torch.models.topiq import TOPIQNet
    from facet_tpu_torch.models.u2netp import U2NETP

    cfg = os.path.join(os.path.dirname(db), "scoring_config_16gb.json")
    write_default_config(cfg)
    with open(cfg) as fh:
        config = json.load(fh)
    config["models"]["vram_profile"] = "16gb"
    with open(cfg, "w") as fh:
        json.dump(config, fh)
    set_scrfd_reg_scale(SCRFD_REG_SCALE)
    nets = (TOPIQNet, U2NETP, SAMPNet, SCRFD, LandmarkNet, IResNet)
    seen = {net.__name__: set() for net in nets}
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, _: seen[type(module).__name__].add(tf32_flags())
        if isinstance(module, nets) else None)
    os.environ["FACET_ENTROPY_IMPL"] = "pallas"
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    out = Tee(sys.stdout)
    with contextlib.redirect_stdout(out):
        rc = cli_main([photo_dir, "--db", db, "--config", cfg])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
    hook.remove()
    del os.environ["FACET_ENTROPY_IMPL"]
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"the default scan exited {rc}")
    skipped = [ln for ln in text.splitlines() if "unavailable" in ln]
    if skipped:
        raise AssertionError(f"the default scan skipped members: {skipped}")
    for name in launches:
        if (launches[name] > 0) != (name in DEFAULT_MUST):
            raise AssertionError(f"kernel {name} launched {launches[name]} times during "
                                 f"the default scan")
    for name, flags in seen.items():
        if not flags or any(any(f) for f in flags):
            raise AssertionError(f"{name}'s forward ran with TF32 flags {flags} in the "
                                 f"default scan; it must run in full float32")
    conn = sqlite3.connect(db)
    rows = [dict(zip(DEFAULT_COLUMNS, r)) for r in conn.execute(
        f"SELECT {', '.join(DEFAULT_COLUMNS)} FROM photos ORDER BY path")]
    faces = conn.execute("SELECT photo_path, embedding, landmark_2d_106, face_thumbnail,"
                         " bbox_x1, bbox_y1, bbox_x2, bbox_y2 FROM faces").fetchall()
    conn.close()
    if [r["path"] for r in rows] != [r["path"] for r in quality_rows]:
        raise AssertionError("the default scan wrote other photos than the quality scan")
    for row, want in zip(rows, quality_rows):
        for col in ("aesthetic", "topiq_score", "phash", "aggregate", "clip_embedding",
                    "comp_score", "power_point_score", "composition_pattern", "face_count"):
            if row[col] is None:
                raise AssertionError(f"null {col} in row {row['path']} (default scan)")
        if row["scoring_model"] != "topiq" or row["leading_lines_score"] is not None:
            raise AssertionError(f"{row['path']}: scored by {row['scoring_model']!r}, "
                                 f"leading lines {row['leading_lines_score']!r}: not "
                                 f"TOPIQ and SAMP-Net")
        if row["face_count"] and any(row[c] is None for c in FACE_FLOATS):
            raise AssertionError(f"{row['path']}: face columns not filled: "
                                 f"{[(c, row[c]) for c in FACE_FLOATS]}")
        for col in EXACT_COLUMNS:
            # a --pass scan's aggregate recompute rewrites exposure_score to 4
            # places (both packages); the default scan keeps the statistics'
            # 2-place value
            if (abs(row[col] - want[col]) > 0.005 if col == "exposure_score"
                    else row[col] != want[col]):
                raise AssertionError(f"{col} differs between the default and the "
                                     f"--pass quality scans at {row['path']}")
    counted = sum(r["face_count"] for r in rows)
    if not faces or len(faces) != counted:
        raise AssertionError(f"{len(faces)} faces rows for {counted} faces counted")
    for path, emb, lmk, thumb, *box in faces:
        emb = np.frombuffer(emb, np.float32)
        lmk = np.frombuffer(lmk, np.float32)
        if emb.shape != (512,) or lmk.shape != (212,) or not (
                np.isfinite(emb).all() and np.isfinite(lmk).all()):
            raise AssertionError(f"a faces row of {path}: embedding {emb.shape}, "
                                 f"landmarks {lmk.shape}, or not finite")
        if box[2] <= box[0] or box[3] <= box[1]:
            raise AssertionError(f"a faces row of {path}: box {box}")
        # the face pipeline writes a thumbnail exactly when its crop of the
        # 30%-padded box, sliced as numpy slices it (a negative end counts
        # from the far side), holds pixels: random boxes may lie off the photo
        h, w = map(int, os.path.basename(path).split("_")[1].split("x"))
        pad_x, pad_y = 0.3 * (box[2] - box[0]), 0.3 * (box[3] - box[1])
        inside = (len(range(w)[int(max(0, box[0] - pad_x)):int(min(w, box[2] + pad_x))])
                  and len(range(h)[int(max(0, box[1] - pad_y)):int(min(h, box[3] + pad_y))]))
        if bool(inside) != (thumb is not None) or (thumb and thumb[:2] != b"\xff\xd8"):
            raise AssertionError(f"a faces row of {path}: box {box}, thumbnail "
                                 f"{thumb[:4] if thumb else thumb}")
    big = [r for r in rows if f"_{SCAN_SHAPES[0][0]}x" in os.path.basename(r["path"])]
    phase("default", f"TF32 flags (cudnn, matmul) inside each float32 member's forwards: "
                     f"{ {name: sorted(flags) for name, flags in seen.items()} }")
    phase("default", f"{len(rows)} rows complete (SAMP-Net composition, patterns "
                     f"{sorted({r['composition_pattern'] for r in rows})}); {counted} faces "
                     f"on {sum(1 for r in rows if r['face_count'])} photos, "
                     f"{len(faces)} faces rows (512-d embedding, 106x2 landmarks), "
                     f"{sum(1 for f in faces if f[3])} with a JPEG thumbnail; "
                     f"pHash and integer columns equal the --pass quality scan's")
    phase("default", f"kernel launches during the scan {launches}; "
                     f"{len(rows) / seconds:.2f} images/s end to end ({seconds:.1f} s, {gpu})")
    for ln in text.splitlines():
        if "phases:" in ln or "scan complete:" in ln or "multi-pass:" in ln:
            phase("default", ln.strip())
    return launches, sum(r["face_count"] for r in big), rows


def time_members(gpu, crops):
    """Device time of each new member per batch of 24 at 1024x1536: CUDA
    events (host launches included) and replayed from a CUDA graph."""
    from facet_tpu_torch.models.face_pipeline import FacePipeline
    from facet_tpu_torch.models.samp_net import SAMPComposition

    h, w = SCAN_SHAPES[0]
    b = SCAN_COUNTS[0]
    crops = max(crops, 1)
    dev = torch.from_numpy(np.stack(synthetic_photos(b, h, w, seed=h * 7))).cuda()
    samp = SAMPComposition.create(None, None, "cuda")
    faces = FacePipeline.create(None, None, "cuda")
    samp_run, _ = samp.rider(h, w)
    det_run, _ = faces._detect_program(h, w)
    gen = torch.Generator(device="cuda").manual_seed(5)
    lmk = torch.rand((crops, 192, 192, 3), device="cuda", generator=gen) * 2 - 1
    emb = torch.rand((crops, 112, 112, 3), device="cuda", generator=gen) * 2 - 1

    def net_call(net, x):
        def call():
            with torch.no_grad(), full_float32():
                return net(x)
        return call

    members = {"samp rider (224 px resize, U2-Net-P, SAMP-Net)": lambda: samp_run(dev),
               "SCRFD detect + decode (640 px letterbox, det_10g, top-64)":
                   lambda: det_run(dev),
               f"landmark net on {crops} crops (192 px)": net_call(faces.landmark_net, lmk),
               f"ArcFace on {crops} crops (112 px)": net_call(faces.embedder, emb)}
    with torch.no_grad():
        for name, fn in members.items():
            events = cuda_median_ms(fn, reps=5)
            graph = graph_ms(fn, launches=3)
            phase("members", f"{name}: {events:.3f} ms by events, {graph:.3f} ms in a "
                             f"CUDA graph, per batch of {b} at {h}x{w} ({gpu})")
    del samp, faces, dev
    torch.cuda.empty_cache()


def compare_rows(got, want):
    """The pallas_fused scan's rows against the default scan's."""
    if [r["path"] for r in got] != [r["path"] for r in want]:
        raise AssertionError("the two scans wrote different photos")
    worst = {"raw_color_entropy": 0.0, "scores": 0.0}
    for g, w in zip(got, want):
        for col in EXACT_COLUMNS:
            if g[col] != w[col]:
                raise AssertionError(f"{col} differs between the scans at {g['path']}")
        d = abs(g["raw_color_entropy"] - w["raw_color_entropy"])
        if d > ENTROPY_TOL:
            raise AssertionError(f"raw_color_entropy differs by {d} at {g['path']}")
        worst["raw_color_entropy"] = max(worst["raw_color_entropy"], d)
        for col in SCORE_COLUMNS:
            d = abs(g[col] - w[col])
            if d > SCORE_TOL:
                raise AssertionError(f"{col} differs by {d} at {g['path']}")
            worst["scores"] = max(worst["scores"], d)
    return worst


def compare_attention_rows(got, want, impl):
    """A scan under another ViT attention schedule against the default's:
    what the ViT does not feed is unchanged, and each CLIP embedding keeps
    its direction. Photos whose tags differ are counted, not failed."""
    if [r["path"] for r in got] != [r["path"] for r in want]:
        raise AssertionError(f"the {impl} scan wrote other photos than the default")
    worst = {"score": 0.0, "cosine": 1.0, "tags_differ": 0}
    for g, w in zip(got, want):
        for col in EXACT_COLUMNS:
            if g[col] != w[col]:
                raise AssertionError(f"{col} differs between the {impl} and default "
                                     f"scans at {g['path']}")
        for col in TOPIQ_COLUMNS:
            d = abs(g[col] - w[col])
            if d > SCORE_TOL:
                raise AssertionError(f"{col} differs by {d} at {g['path']} ({impl})")
            worst["score"] = max(worst["score"], d)
        a = np.frombuffer(g["clip_embedding"], np.float32).astype(np.float64)
        b = np.frombuffer(w["clip_embedding"], np.float32).astype(np.float64)
        cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        if not cosine >= EMBEDDING_MIN_COSINE:
            raise AssertionError(f"clip_embedding cosine {cosine} < {EMBEDDING_MIN_COSINE} "
                                 f"at {g['path']} ({impl})")
        worst["cosine"] = min(worst["cosine"], cosine)
        worst["tags_differ"] += g["tags"] != w["tags"]
    return worst


def phase_scan(gpu, tmp):
    """Phases 4 and 5 over the smoke's photos, written under tmp/photos ->
    (launches by scan, the default scan's rows)."""
    phase("scan", f"process TF32 flags (cudnn, matmul), torch's defaults: "
                  f"{tf32_flags()}")
    photo_dir = os.path.join(tmp, "photos")
    os.makedirs(photo_dir)
    paths = write_photos(photo_dir)
    cfg = os.path.join(tmp, "scoring_config.json")
    scans = {impl: run_scan(photo_dir, os.path.join(tmp, f"{impl}.db"), cfg,
                            impl, gpu) for impl in SCANS}
    default, crops, default_rows = run_default_scan(
        photo_dir, os.path.join(tmp, "default.db"), scans["pallas"][0], gpu)
    time_members(gpu, crops)
    for rows, _ in scans.values():
        if len(rows) != len(paths):
            raise AssertionError(f"{len(rows)} rows for {len(paths)} photos")
    worst = compare_rows(scans["pallas_fused"][0], scans["pallas"][0])
    phase("scan", f"pallas_fused rows against the default's: pHash and integer "
                  f"columns identical, max|d raw_color_entropy|="
                  f"{worst['raw_color_entropy']:.3g} (tol {ENTROPY_TOL}), max|d "
                  f"score|={worst['scores']:.3g} (tol {SCORE_TOL})")
    for impl in ("psoftmax", "flash"):
        worst = compare_attention_rows(scans[impl][0], scans["pallas"][0], impl)
        phase("scan", f"{impl} rows against the default's: pHash and integer columns "
                      f"identical, max|d TOPIQ score|={worst['score']:.3g} (tol "
                      f"{SCORE_TOL}), min clip_embedding cosine {worst['cosine']:.6f} "
                      f"(limit {EMBEDDING_MIN_COSINE}), tags differ on "
                      f"{worst['tags_differ']} of {len(paths)} photos")
    return {"default": default,
            **{impl: launches for impl, (_, launches) in scans.items()}}, default_rows


# ------------------------------------------------ phase 6: the VLM tagger

# The first decoder layer in bf16 on the card against the same weights in
# float64 on the CPU: the relative RMS of its output (bf16 rounds at about
# 2^-9 relative; the layer rounds at a dozen points).
LAYER_BF16_REL_TOL = 2e-2
# The first vision block and the merger in float32 (TF32 off) against
# float64: float32 rounding, 6e-8 relative, summed over 1280-5120 terms.
LAYER_F32_REL_TOL = 1e-5
# The cached decode against the cache-less forward (bf16 scores where the
# cache path holds float32 ones), teacher-forced over the prompt and the
# generated tokens: logits of magnitude up to about 4 may differ by
# DECODE_LOGIT_TOL (4 bf16 ulps there; measured 0.035 on the CPU for 24
# layers of width 896, and 0.031 at full width on the card); a greedy
# token must be the cache-less argmax wherever the top-2 gap there exceeds
# twice that, and nearer ties are counted and printed.
DECODE_LOGIT_TOL = 0.0625
# photos of each shape the scan with the tagger covers
TAGGER_PHOTOS_PER_SHAPE = 2
TAGGER_SEED = 8


def build_tagger(config, device="cuda"):
    """The Qwen2.5-VL-7B tagger at its published widths with random weights
    drawn on the card (torch.Generator, TAGGER_SEED), and the stand-in
    processor -> (VLMTagger, seconds to build)."""
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models.qwen_text import QwenTextDecoder, QwenTextModel
    from facet_tpu_torch.models.qwen_vision import QwenVisionEncoder, QwenVisionTower
    from facet_tpu_torch.models.vlm_tagger import VLMTagger

    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(TAGGER_SEED)
    tagger = VLMTagger(config, device=device)
    encoder = QwenVisionEncoder(P.random_init_(QwenVisionTower(device=device), gen))
    model = P.random_init_(QwenTextModel(dtype=torch.bfloat16, device=device), gen)
    tagger.install(StandInProcessor(tagger.vocabulary), encoder,
                   QwenTextDecoder(model, tagger.max_new_tokens))
    torch.cuda.synchronize()
    return tagger, time.time() - t0


def rel_rms(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def check_tagger_layers(tagger, gpu):
    """The first decoder layer (bf16), the first vision block and the merger
    (float32, TF32 off) at full width on 256 tokens, against the same
    weights in float64 on the CPU."""
    from facet_tpu_torch.models.qwen_text import DecoderLayer, mrope_cos_sin
    from facet_tpu_torch.models.qwen_vision import QwenVisionTower, VisionBlock

    encoder, decoder = tagger._device
    cfg, tower, dev = decoder.config, encoder.tower, decoder.device
    gen = torch.Generator(device=dev).manual_seed(3)
    n = 256
    # hidden states at the token embeddings' scale (std 0.02), so that the
    # layer's output is mostly its own work and not its residual input
    x = (0.02 * torch.randn((1, n, cfg.hidden_size), device=dev, generator=gen)).to(torch.bfloat16)
    pos = torch.randint(0, 300, (3, 1, n), device=dev, generator=gen)
    mask = torch.ones((n, n), dtype=torch.bool, device=dev).tril()[None]
    layer = decoder.model.layers[0]
    ref = DecoderLayer(cfg, torch.float64, "cpu")
    ref.load_state_dict(layer.state_dict())
    with torch.no_grad():
        got = layer(x, *mrope_cos_sin(pos, cfg, torch.bfloat16), mask).cpu()
        want = ref(x.cpu().double(), *mrope_cos_sin(pos.cpu(), cfg, torch.float64), mask.cpu())
    err_text = rel_rms(got, want)
    del ref

    # 256 patches of a 16x16 grid: four whole windows of 64 tokens
    vcfg = tower.config
    _, valid, _, cos, sin, nwin = tower.layout(16, 16)
    xv = torch.randn((nwin, n // nwin, vcfg.hidden_size), device=dev, generator=gen)
    block = tower.blocks[0]
    ref_block = VisionBlock(vcfg, "cpu").double()
    ref_block.load_state_dict(block.state_dict())
    ref_tower = QwenVisionTower(replace(vcfg, depth=0), "cpu").double()
    ref_tower.load_state_dict({k: v for k, v in tower.state_dict().items()
                               if not k.startswith("blocks.")})
    tok_valid = valid.repeat_interleave(4).view(nwin, -1)
    rope = [t.view(nwin, -1, t.shape[-1]) for t in (cos, sin)]
    with torch.no_grad(), full_float32():
        got_block = block(xv, *rope, tok_valid).cpu()
        got_merge = tower.merger(xv.reshape(n, -1)).cpu()
    with torch.no_grad():
        want_block = ref_block(xv.cpu().double(), *[t.cpu().double() for t in rope],
                               tok_valid.cpu())
        want_merge = ref_tower.merger(xv.cpu().double().reshape(n, -1))
    xv64 = xv.cpu().double()
    err_block = rel_rms(got_block.double() - xv64, want_block - xv64)
    err_merge = rel_rms(got_merge, want_merge)
    for name, err, tol in (("first decoder layer (bf16)", err_text, LAYER_BF16_REL_TOL),
                           ("first vision block (f32)", err_block, LAYER_F32_REL_TOL),
                           ("merger (f32)", err_merge, LAYER_F32_REL_TOL)):
        if not err <= tol:
            raise AssertionError(f"{name} on {n} tokens: relative RMS error {err} against "
                                 f"float64 on the CPU, above {tol}")
    phase("tagger", f"at full width on {n} tokens against float64 on the CPU, relative RMS "
                    f"error: first decoder layer {err_text:.3g} (bf16, tol "
                    f"{LAYER_BF16_REL_TOL}), first vision block's increment {err_block:.3g}, "
                    f"merger {err_merge:.3g} (f32, tol {LAYER_F32_REL_TOL})")


def check_tagger_decode(tagger, pils, gpu):
    """The cached greedy decode of a batch of two photos of different
    shapes (the shorter prompt left-padded) against the cache-less forward
    over the prompt and the generated tokens."""
    from facet_tpu_torch.models.vlm_tagger import prepare_inputs

    encoder, decoder = tagger._device
    model, dev = decoder.model, decoder.device
    embeds, valid, pos, next_pos, eos = prepare_inputs(
        tagger._processor, encoder, decoder, pils, tagger.build_prompt())
    out = decoder.generate(embeds, valid, pos, next_pos, eos)
    b, t, _ = embeds.shape
    n = out.shape[1]
    with torch.no_grad():
        full = torch.cat([embeds, model.embed_tokens(
            torch.as_tensor(out[:, :-1], device=dev)).float()], 1)
        gen_pos = next_pos[None, :, None] + np.arange(n - 1)[None, None, :]
        all_pos = torch.as_tensor(np.concatenate(
            [pos, np.broadcast_to(gen_pos, (3, b, n - 1))], 2), device=dev)
        keep = torch.cat([torch.as_tensor(valid, device=dev),
                          torch.ones((b, n - 1), dtype=torch.bool, device=dev)], 1)
        mask = torch.ones((t + n - 1,) * 2, dtype=torch.bool, device=dev).tril()[None] \
            & keep[:, None, :]
        last = np.where(valid, np.arange(t), -1).max(1)
        steps = torch.as_tensor(np.stack([np.concatenate([[r], t + np.arange(n - 1)])
                                          for r in last]), device=dev)
        rows = torch.arange(b, device=dev)[:, None]
        plain = model(full, all_pos, mask)[rows, steps]
        cache = [tuple(torch.zeros((b, decoder.config.num_kv_heads, t + n - 1,
                                    decoder.config.head_dim), device=dev)
                       for _ in range(2)) for _ in range(decoder.config.num_layers)]
        cached = model(full, all_pos, mask, cache, 0)[rows, steps]
    # compare each row up to and including its first EOS
    upto = [int(np.nonzero(np.isin(r, eos))[0][0]) + 1 if np.isin(r, eos).any() else n
            for r in out]
    live = torch.as_tensor(np.arange(n)[None, :] < np.array(upto)[:, None], device=dev)
    diff = float((plain - cached).abs().amax(-1)[live].max())
    top2 = plain.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    agree = plain.argmax(-1).cpu().numpy() == out
    agree = torch.as_tensor(agree, device=dev)
    clear = live & (gap > 2 * DECODE_LOGIT_TOL)
    wrong = int((clear & ~agree).sum())
    near = int((live & ~(gap > 2 * DECODE_LOGIT_TOL)).sum())
    near_differ = int((live & ~(gap > 2 * DECODE_LOGIT_TOL) & ~agree).sum())
    if diff > DECODE_LOGIT_TOL or wrong:
        raise AssertionError(f"cached decode against the cache-less forward: max|d logit| "
                             f"{diff} (tol {DECODE_LOGIT_TOL}), {wrong} tokens that are not "
                             f"the argmax where the top-2 gap exceeds {2 * DECODE_LOGIT_TOL}")
    phase("tagger", f"cached greedy decode of 2 photos (prompts of {valid.sum(1).tolist()} "
                    f"tokens padded to {t}, {n} new tokens, stops after {upto}) against the "
                    f"cache-less forward: max|d logit| {diff:.4g} teacher-forced (tol "
                    f"{DECODE_LOGIT_TOL}, logits up to {float(plain.abs().max()):.3g}); "
                    f"{int(clear.sum())} tokens with a top-2 gap above "
                    f"{2 * DECODE_LOGIT_TOL} all agree; {near} near ties, {near_differ} of "
                    f"them decoded otherwise; {int((live & agree).sum())} of "
                    f"{int(live.sum())} tokens are the cache-less argmax")
    del plain, cached, cache, full
    return embeds, valid, pos, next_pos, eos


def tagger_bounds(tagger, grids, valid):
    """Least times (ms) of one batch on the card, from this batch's shapes:
    the vision tower (float32 operations of its real tokens), the prefill
    (bf16 operations of the valid prompt tokens) and one decode step (the
    bytes of the decoder's weights, lm_head included, and of its cache)."""
    from facet_tpu_torch.models.qwen_vision import window_layout

    encoder, decoder = tagger._device
    vcfg, cfg = encoder.config, decoder.config
    e, i, unit = vcfg.hidden_size, vcfg.intermediate_size, vcfg.spatial_merge_size ** 2
    vision_ops = 0
    for _, gh, gw in grids:
        lay = window_layout(vcfg, gh, gw)
        tokens = gh * gw
        per_window = lay["valid"].reshape(lay["n_windows"], -1).sum(1) * unit
        dense = 2 * tokens * (4 * e * e + 3 * e * i)          # qkv, proj, gate/up/down
        full = len(vcfg.fullatt_block_indexes)
        attn = 4 * e * ((vcfg.depth - full) * float((per_window ** 2).sum()) + full * tokens ** 2)
        merger = 2 * (tokens // unit) * (unit * e) * (unit * e + vcfg.out_hidden_size)
        vision_ops += vcfg.depth * dense + attn + 2 * tokens * vcfg.patch_dim * e + merger
    hd = cfg.head_dim
    layer_params = (cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                    + cfg.num_heads * hd * cfg.hidden_size
                    + 3 * cfg.hidden_size * cfg.intermediate_size)
    head = cfg.vocab_size * cfg.hidden_size
    lens = valid.sum(1)
    prefill_ops = float(sum(2 * cfg.num_layers * layer_params * n + 2 * head
                            + 2 * cfg.num_layers * 2 * cfg.num_heads * hd * n * (n + 1) / 2
                            for n in lens))
    b, t = valid.shape
    cache_bytes = cfg.num_layers * 2 * b * (t + decoder.max_new_tokens) * cfg.num_kv_heads * hd * 4
    step_bytes = 2 * (cfg.num_layers * layer_params + head) + cache_bytes
    return {"vision": bound(0, vision_ops, FP32_OPS),
            "prefill": bound(2 * (cfg.num_layers * layer_params + head), prefill_ops, BF16_FLOPS),
            "decode step": bound(step_bytes, 0, BF16_FLOPS)}


def time_tagger(tagger, pils, inputs, gpu):
    """CUDA-event times of one batch of two photos: the vision encode, the
    prefill (a decode of one token) and each further decode step, beside
    their bounds."""
    from facet_tpu_torch.models.qwen_text import QwenTextDecoder

    encoder, decoder = tagger._device
    processed = tagger._processor(text=["<|image_pad|>"] * len(pils), images=pils)
    grids = processed["image_grid_thw"].tolist()
    embeds, valid, pos, next_pos, eos = inputs
    prefill = QwenTextDecoder(decoder.model, 1)
    times = {
        "vision": cuda_median_ms(lambda: encoder.encode(processed["pixel_values"], grids),
                                 reps=3, warmup=1),
        "prefill": cuda_median_ms(lambda: prefill.generate(embeds, valid, pos, next_pos, eos),
                                  reps=3, warmup=1),
        "generate": cuda_median_ms(lambda: decoder.generate(embeds, valid, pos, next_pos, eos),
                                   reps=2, warmup=0)}
    steps = decoder.max_new_tokens - 1
    times["decode step"] = (times["generate"] - times["prefill"]) / steps
    bounds = tagger_bounds(tagger, grids, valid)
    for name in ("vision", "prefill", "decode step"):
        b_ms, by = bounds[name]
        phase("tagger", f"{name}: {times[name]:.3f} ms per batch of {len(pils)} "
                        f"(grids {grids}, prompts of {valid.sum(1).tolist()} tokens padded to "
                        f"{valid.shape[1]}); bound {b_ms:.3f} ms by {by} ({gpu})")
    phase("tagger", f"whole generate ({steps} decode steps, no early stop): "
                    f"{times['generate']:.3f} ms per batch ({gpu})")
    return times


def run_tagger_scan(photo_dir, db, tagger, gpu):
    """``python -m facet_tpu_torch <dir>`` under the default config
    (``vram_profile: auto``), with ``tagger`` registered for vlm_tagger
    through ModelManager.register when given -> (rows, launches, printed
    lines, seconds)."""
    from facet_tpu_torch.__main__ import main as cli_main
    from facet_tpu_torch.config.default_config import write_default_config
    from facet_tpu_torch.models.model_manager import ModelManager

    cfg = os.path.join(os.path.dirname(db), "scoring_config_auto.json")
    write_default_config(cfg, overwrite=True)
    defaults = ModelManager._register_default_factories

    def register(manager):
        defaults(manager)
        if tagger is not None:
            manager.register("vlm_tagger", lambda config, cached: tagger)

    ModelManager._register_default_factories = register
    os.environ["FACET_ENTROPY_IMPL"] = "pallas"
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    out = Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main([photo_dir, "--db", db, "--config", cfg])
        torch.cuda.synchronize()
    finally:
        ModelManager._register_default_factories = defaults
        del os.environ["FACET_ENTROPY_IMPL"]
    seconds = time.time() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
    if rc != 0:
        raise AssertionError(f"the 24gb scan exited {rc}")
    lines = out.getvalue().splitlines()
    plan = [ln for ln in lines if ln.startswith("multi-pass:")]
    if not plan or "'vlm_tagger'" not in plan[0]:
        raise AssertionError(f"vram_profile auto did not resolve to the 24gb profile: {plan}")
    for name, count in launches.items():
        if count != (2 if name in DEFAULT_MUST else 0):
            raise AssertionError(f"kernel {name} launched {count} times during the 24gb scan; "
                                 f"K1, K5 and K2 must launch twice each, and nothing else")
    conn = sqlite3.connect(db)
    rows = [dict(zip(DEFAULT_COLUMNS, r)) for r in conn.execute(
        f"SELECT {', '.join(DEFAULT_COLUMNS)} FROM photos ORDER BY path")]
    conn.close()
    return rows, launches, lines, seconds


def phase_tagger(gpu, tmp, default_rows):
    """Phase 6: the Qwen2.5-VL-7B tagger at full width on the card -> the
    launch counts of the two 24gb scans."""
    from facet_tpu_torch.config.scoring_config import ScoringConfig
    from facet_tpu_torch.models.model_manager import MODEL_DEVICE_REQUIREMENTS
    from facet_tpu_torch.models.qwen_vision import QwenVisionTower
    from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
    from facet_tpu_torch.processing.scorer import Facet
    from facet_tpu_torch.utils.image_loading import gather_image_files
    from facet_tpu_torch.utils.tags import tags_to_string

    photo_dir = os.path.join(tmp, "photos")
    # nothing installed: the chain falls back to CLIP tags, rows as the 16gb scan's
    rows, plain_launches, lines, seconds = run_tagger_scan(
        photo_dir, os.path.join(tmp, "auto.db"), None, gpu)
    chain = [ln.strip() for ln in lines if "unavailable" in ln]
    if [ln.split(":")[0] for ln in chain] != ["pass vlm_tagger", "pass qwen3_vl_tagger",
                                              "pass ram_tagger"]:
        raise AssertionError(f"the 24gb scan with nothing installed printed {chain}")
    if [r["path"] for r in rows] != [r["path"] for r in default_rows]:
        raise AssertionError("the 24gb scan wrote other photos than the 16gb scan")
    worst = compare_attention_rows(rows, default_rows, "24gb")
    for row, want in zip(rows, default_rows):
        for col in DEFAULT_COLUMNS:
            same = (abs(row[col] - want[col]) <= SCORE_TOL
                    if isinstance(row[col], float) and isinstance(want[col], float)
                    else col in ("clip_embedding", "tags") or row[col] == want[col])
            if not same:
                raise AssertionError(f"{col} at {row['path']}: {row[col]!r} in the 24gb scan "
                                     f"with nothing installed, {want[col]!r} in the 16gb scan")
        if row["clip_embedding"] == want["clip_embedding"] and row["tags"] != want["tags"]:
            raise AssertionError(f"{row['path']}: the same CLIP embedding as the 16gb scan's "
                                 f"and other tags")
    for ln in chain:
        phase("tagger", ln)
    phase("tagger", f"nothing installed: vram_profile auto ran the 24gb profile; {len(rows)} "
                    f"rows equal the 16gb scan's (floats within {SCORE_TOL}, CLIP embeddings "
                    f"at cosine >= {worst['cosine']:.7f}, tags by CLIP, differing on "
                    f"{worst['tags_differ']} photos); launches {plain_launches}; "
                    f"{len(rows) / seconds:.2f} images/s ({gpu})")

    config = ScoringConfig(os.path.join(tmp, "scoring_config_auto.json"))
    tagger, build_s = build_tagger(config)
    phase("tagger", f"Qwen2.5-VL-7B at full width (vision tower f32, decoder bf16), random "
                    f"weights drawn on the card in {build_s:.1f} s; "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({gpu})")
    check_tagger_layers(tagger, gpu)
    seen = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, _: seen.append(tf32_flags())
        if isinstance(module, QwenVisionTower) else None)

    # the subset: TAGGER_PHOTOS_PER_SHAPE photos of each shape, in a folder
    sub_dir = os.path.join(tmp, "tagger_photos")
    os.makedirs(sub_dir)
    for (h, w) in SCAN_SHAPES:
        for i in range(TAGGER_PHOTOS_PER_SHAPE):
            name = f"photo_{h}x{w}_{i:02d}.jpg"
            os.link(os.path.join(photo_dir, name), os.path.join(sub_dir, name))
    files = gather_image_files(sub_dir)
    facet = Facet(os.path.join(tmp, "direct.db"), config, device=tagger.device)
    _, _, pils, _ = ChunkedMultiPassProcessor(facet)._load_chunk(files)
    inputs = check_tagger_decode(tagger, [pils[0], pils[-1]], gpu)
    time_tagger(tagger, pils[:TAGGER_PHOTOS_PER_SHAPE], inputs, gpu)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    direct = tagger.tag_batch(pils)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    budget = MODEL_DEVICE_REQUIREMENTS["vlm_tagger"]
    phase("tagger", f"memory: {resident / 2**30:.2f} GiB resident (weights), peak "
                    f"{peak / 2**30:.2f} GiB while tagging {len(pils)} photos in batches of "
                    f"{tagger.batch_size}, against the {budget} GB budget "
                    f"({peak / 1e9:.2f} GB; {gpu})")
    rows, launches, lines, seconds = run_tagger_scan(
        sub_dir, os.path.join(tmp, "tagged.db"), tagger, gpu)
    hook.remove()
    skipped = [ln for ln in lines if "unavailable" in ln or "skipped" in ln]
    if skipped or tagger.skipped_batches:
        raise AssertionError(f"the scan with the tagger skipped: {skipped}, "
                             f"{tagger.skipped_batches} batches")
    want = {os.path.abspath(f): tags_to_string(t) for f, t in zip(files, direct)}
    for row in rows:
        if not row["tags"] or row["tags"] != want[row["path"]]:
            raise AssertionError(f"{row['path']}: tags {row['tags']!r} in the scan, "
                                 f"{want[row['path']]!r} from the tagger directly")
    if not seen or any(any(flags) for flags in seen):
        raise AssertionError(f"the vision tower ran with TF32 flags {seen}; it must run in "
                             f"full float32")
    phase("tagger", f"TF32 flags (cudnn, matmul) inside the vision tower's "
                    f"{len(seen)} forwards: {sorted(set(seen))}")
    phase("tagger", f"with the tagger registered: {len(rows)} rows, each row's tags the "
                    f"tagger's own ({sorted({r['tags'] for r in rows})}); no batch skipped; "
                    f"launches {launches}; {len(rows) / seconds:.3f} images/s end to end, "
                    f"model builds included ({seconds:.1f} s, {gpu})")
    for ln in lines:
        if "phases:" in ln or "scan complete:" in ln:
            phase("tagger", ln.strip())
    del tagger, facet
    torch.cuda.empty_cache()
    return {"24gb": plain_launches, "24gb_tagger": launches}


# name -> (source, the TPU kernel it replaces, the scan whose count is its
# launches on the main path: the default multi-pass scan for the kernels of
# the default configuration, else the scan of the setting that selects the
# kernel; kernel 3 is on no path of the engine)
KERNELS = {
    "hs_entropy": ("facet_tpu_torch/csrc/hs_entropy.cu",
                   "facet_tpu/ops/pallas_entropy.py:252", "default"),
    "hs_entropy_fixed": ("facet_tpu_torch/csrc/hs_entropy.cu",
                         "facet_tpu/ops/pallas_entropy.py:116", "default"),
    "fused_stats": ("facet_tpu_torch/csrc/fused_stats.cu",
                    "facet_tpu/ops/pallas_fused_stats.py:236", "pallas_fused"),
    "gray_stats": ("facet_tpu_torch/csrc/gray_stats.cu",
                   "facet_tpu/ops/pallas_stats.py:168", "default"),
    "cross_attention": ("facet_tpu_torch/csrc/cross_attention.cu",
                        "facet_tpu/ops/pallas_attn.py:96", "default"),
    "softmax": ("facet_tpu_torch/csrc/row_softmax.cu",
                "facet_tpu/ops/pallas_softmax.py:53", "psoftmax"),
    "flash_attention": ("facet_tpu_torch/csrc/vit_attention.cu",
                        "facet_tpu/models/clip.py:60", "flash"),
}


# the checks that --ab runs, by name
AB_CHECKS = ("softmax", "entropy", "entropy_fixed", "fused_stats", "gray_stats",
             "attention", "vit_attention", "prepass")


def ab_kernels(other, names=AB_CHECKS):
    """The checks ``names`` (check_<name>) of the kernels of the checkout
    ``other`` and of this one, in turns (other, this, this, other), each in
    a process of its own that imports that tree's facet_tpu_torch, builds
    its kernels and runs this file's checks on them, so both trees are
    timed by the same code."""
    here = os.path.abspath(__file__)
    unknown = set(names) - set(AB_CHECKS)
    if unknown:
        raise SystemExit(f"--ab: unknown checks {sorted(unknown)}; known: {AB_CHECKS}")
    code = ("import importlib.util, sys; sys.path.insert(0, '.'); "
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {here!r}); "
            "c = importlib.util.module_from_spec(spec); spec.loader.exec_module(c); "
            "g = c.phase_device(); c.phase_build(); "
            + "; ".join(f"c.check_{name}(g)" for name in names))
    for tree in (other, os.path.dirname(here), os.path.dirname(here), other):
        phase("ab", os.path.abspath(tree))
        subprocess.run([sys.executable, "-c", code], cwd=tree, check=True)
    return 0


def host_timed(owner, name, totals):
    """Wrap owner.name so that its host time adds up in totals[name]."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            totals[name] += time.perf_counter() - t0

    setattr(owner, name, wrapper)


def probe_run(processor, files, totals, label, gpu, profile=False):
    """One default scan over files on a resident engine: wall time, images/s,
    phase times and stage host times; under ``profile``, torch.profiler's
    device activity too (busy share and the kernels that take most)."""
    import collections

    for key in totals:
        totals[key] = 0.0
    for key in processor.phase_times:
        processor.phase_times[key] = 0.0
    torch.cuda.synchronize()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    done = processor.process_directory(files, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    phases = ", ".join(f"{k} {v}" for k, v in processor.phase_times.items())
    stages = ", ".join(f"{k} {v}" for k, v in totals.items())
    phase("probe", f"[{label}] {done} photos in {wall} s: {done / wall} images/s ({gpu})")
    phase("probe", f"[{label}] phases (s): {phases}")
    phase("probe", f"[{label}] stages on the host's clock (s): {stages}")
    if prof is None:
        return
    kernels = collections.Counter()
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            kernels[evt.key] += us / 1e6
    busy = sum(kernels.values())
    phase("probe", f"[{label}] device busy {busy} s of {wall} s wall: "
                   f"{100 * busy / wall:.2f}% busy, {100 * (1 - busy / wall):.2f}% idle")
    for name, sec in kernels.most_common(15):
        phase("probe", f"[{label}]   {sec * 1e3:9.3f} ms  {name[:110]}")


def probe_rider_memory(gpu):
    """Each rider's activation peak per image at 1024x1536
    (torch.cuda.max_memory_allocated over one call, batches of 1 and 8, the
    slope), and that less the source copy's 24 bytes a source pixel, per
    pixel of the member's input: the figure rider_slice_size budgets."""
    from facet_tpu_torch.models import face_pipeline as fp
    from facet_tpu_torch.models import samp_net, topiq

    h, w = SCAN_SHAPES[0]
    riders = {"TOPIQ": (lambda: topiq.TOPIQScorer.create(None, None, "cuda").rider(h, w)[0],
                        topiq.TOPIQConfig().input_size, topiq.ACT_BYTES_PER_INPUT_PIXEL),
              "SAMP": (lambda: samp_net.SAMPComposition.create(None, None, "cuda").rider(h, w)[0],
                       samp_net.INPUT_SIZE, samp_net.ACT_BYTES_PER_INPUT_PIXEL),
              "SCRFD": (lambda: fp.FacePipeline.create(None, None, "cuda")._detect_program(
                  h, w)[0], fp.SCRFD_10G.input_size, fp.DET_ACT_BYTES_PER_INPUT_PIXEL)}
    photos = torch.from_numpy(np.stack(synthetic_photos(8, h, w, seed=h * 11))).cuda()
    for name, (make, size, budget) in riders.items():
        run = make()
        peaks = {}
        with torch.no_grad():
            for b in (1, 8):
                run(photos[:b])                  # warm: cuDNN picks its algorithms
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                out = run(photos[:b])
                torch.cuda.synchronize()
                peaks[b] = torch.cuda.max_memory_allocated() - base
                del out
        per_image = (peaks[8] - peaks[1]) / 7
        per_pixel = (per_image - 24 * h * w) / size ** 2
        phase("probe", f"{name} rider at {size} px: activation peak {peaks[1]} B at batch "
                       f"1, {peaks[8]} B at batch 8: {per_image:.0f} B an image, "
                       f"{per_pixel:.1f} B per input pixel beyond the source copy "
                       f"(budgeted {budget}) ({gpu})")
        del run
        torch.cuda.empty_cache()


def probe(gpu):
    """--probe: each rider's activation peak, then the default scan twice on
    one engine over the smoke's photos: cold (every model built on first
    use), warm (models resident) and warm again under torch.profiler; then
    the same three runs of the 24gb scan (vram_profile auto) with the
    full-width tagger registered, over TAGGER_PHOTOS_PER_SHAPE photos of
    each shape."""
    from facet_tpu_torch.config.default_config import write_default_config
    from facet_tpu_torch.config.scoring_config import ScoringConfig
    from facet_tpu_torch.models.face_pipeline import FacePipeline
    from facet_tpu_torch.models.tagger import CLIPTagger
    from facet_tpu_torch.processing import scorer as scorer_mod
    from facet_tpu_torch.processing.device_pipeline import FusedScorer
    from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor

    probe_rider_memory(gpu)
    set_scrfd_reg_scale(SCRFD_REG_SCALE)
    totals = {"score_images": 0.0, "analyze_batch": 0.0, "assemble_row": 0.0,
              "tag_embedding_bytes": 0.0, "save_photos_batch": 0.0}
    host_timed(FusedScorer, "score_images", totals)
    host_timed(FacePipeline, "analyze_batch", totals)
    host_timed(scorer_mod.Facet, "assemble_row", totals)
    host_timed(scorer_mod.Facet, "save_photos_batch", totals)
    host_timed(CLIPTagger, "tag_embedding_bytes", totals)
    with tempfile.TemporaryDirectory() as tmp:
        photo_dir = os.path.join(tmp, "photos")
        os.makedirs(photo_dir)
        files = sorted(write_photos(photo_dir))
        cfg = os.path.join(tmp, "scoring_config.json")
        write_default_config(cfg)
        config = ScoringConfig(cfg)
        config.config["models"]["vram_profile"] = "16gb"
        facet = scorer_mod.Facet(os.path.join(tmp, "scan.db"), config, device="cuda")
        processor = ChunkedMultiPassProcessor(facet)
        processor.detect_and_configure(verbose=True)
        probe_run(processor, files, totals, "cold", gpu)
        probe_run(processor, files, totals, "warm", gpu)
        probe_run(processor, files, totals, "warm, profiled", gpu, profile=True)
        del processor, facet
        torch.cuda.empty_cache()

        # the 24gb scan (vram_profile auto on the card) with the full-width
        # tagger registered, built on first use, over the tagger subset
        from facet_tpu_torch.models.vlm_tagger import VLMTagger

        totals["tag_batch"] = 0.0
        host_timed(VLMTagger, "tag_batch", totals)
        subset = [f for (h, w) in SCAN_SHAPES
                  for f in [p for p in files if f"_{h}x{w}_" in p][:TAGGER_PHOTOS_PER_SHAPE]]
        config = ScoringConfig(cfg)
        facet = scorer_mod.Facet(os.path.join(tmp, "scan24.db"), config, device="cuda")
        facet.models.register("vlm_tagger", lambda c, cached: build_tagger(c)[0])
        processor = ChunkedMultiPassProcessor(facet)
        processor.detect_and_configure(verbose=True)
        probe_run(processor, subset, totals, "24gb cold", gpu)
        probe_run(processor, subset, totals, "24gb warm", gpu)
        probe_run(processor, subset, totals, "24gb warm, profiled", gpu, profile=True)
    return 0


def main():
    gpu = phase_device()
    phase_build()
    measured = phase_kernels(gpu)
    with tempfile.TemporaryDirectory() as tmp:
        launches, default_rows = phase_scan(gpu, tmp)
        launches.update(phase_tagger(gpu, tmp, default_rows))
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[scan][name],
         "launches_by_scan": {impl: counts[name] for impl, counts in launches.items()},
         **measured[name]}
        for name, (source, replaces, scan) in KERNELS.items()]}
    print(gpu)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab_kernels(sys.argv[2], sys.argv[3:] or AB_CHECKS))
    if sys.argv[1:2] == ["--probe"]:
        gpu = phase_device()
        phase_build()
        sys.exit(probe(gpu))
    sys.exit(main())
