"""Chunked multi-pass processing: the port's scan driver.

Counterpart of ``facet_tpu/processing/multi_pass.py``: the default scan
(``process_directory``) and the ``--pass`` scans (quality, embeddings,
tags, composition, faces). The selected members are bin-packed into pass
groups against the device-memory budget. Per chunk the host decodes and
reads EXIF once (decode of chunk N+1 overlaps the device work of chunk N);
in the group that holds clip the fused pass scores every image, with
SCRFD's detection, TOPIQ and SAMP-Net riding the same resident batch;
landmarks and ArcFace then run on the face crops; a pass without clip runs
the statistics and pHash prepass alone. Then tagging, thumbnails, row
assembly with the aggregate, and one SQLite transaction per chunk (face
rows included); after a ``--pass`` scan the aggregates recompute from the
merged rows. Progress reporting and the RAM monitor are the port's copies
of the JAX package's host modules.
"""

import os
import time

import numpy as np

from facet_tpu_torch.ops.phash import phash_batch
from facet_tpu_torch.ops.stats import compute_batch_stats
from facet_tpu_torch.processing.metrics_reporter import MetricsReporter
from facet_tpu_torch.processing.resource_monitor import MultiPassResourceMonitor
from facet_tpu_torch.utils.exif import get_exif_batch
from facet_tpu_torch.utils.image_loading import load_image

PASS_NAMES = {
    "quality": ["clip", "topiq"],
    "tags": ["clip"],
    "composition": ["samp_net"],
    "faces": ["insightface"],
    "embeddings": ["clip"],
}

# unavailable-model fallback chain of the one quality model the ported passes
# request (reference: multi_pass.py:864-885); clipiqa is not ported, so a
# TOPIQ that fails to load ends in "unavailable" and the CLIP aesthetic
FALLBACK_CHAINS = {"topiq": ["clipiqa"]}
QUALITY_PASS_MODELS = ("topiq", "clipiqa")

# Column ownership for --pass partial updates: a single pass only
# overwrites the columns of the models it actually ran plus the
# always-recomputed prepass columns; everything else on an EXISTING row is
# preserved, and the aggregate/category recompute afterwards from the
# MERGED row (scorer.update_all_aggregates). The reference's
# run_single_pass REPLACEs full rows with 5.0/0 defaults for the models it
# skipped (multi_pass.py:764-861) — a deliberate data-preserving
# divergence, documented in docs/MIGRATION.md.
PREPASS_COLUMNS = (
    "filename", "date_taken", "camera_model", "lens_model", "iso", "f_stop",
    "shutter_speed", "focal_length", "focal_length_35mm", "image_width",
    "image_height", "tech_sharpness", "color_score", "exposure_score",
    "raw_sharpness_variance", "histogram_data", "histogram_spread",
    "mean_luminance", "histogram_bimodality", "raw_color_entropy",
    "shadow_clipped", "highlight_clipped", "dynamic_range_stops",
    "noise_sigma", "contrast_score", "mean_saturation", "is_monochrome",
    "is_silhouette", "thumbnail", "phash",
)
QUALITY_COLUMNS = ("quality_score", "topiq_score", "aesthetic", "scoring_model")
MODEL_COLUMNS = {
    "clip": ("aesthetic", "clip_embedding", "tags", "scoring_model"),
    "samp_net": ("comp_score", "composition_pattern",
                 "composition_explanation", "power_point_score",
                 "leading_lines_score"),
    "insightface": ("face_count", "face_quality", "eye_sharpness",
                    "face_sharpness", "face_ratio", "is_blink",
                    "is_group_portrait", "face_confidence",
                    "raw_eye_sharpness", "isolation_bonus"),
    "topiq": QUALITY_COLUMNS,
    "clipiqa": QUALITY_COLUMNS,
}


class ChunkedMultiPassProcessor:
    def __init__(self, scorer, model_manager=None, config=None):
        self.scorer = scorer
        self.config = config or scorer.config
        self.models = model_manager or scorer.models
        processing = self.config.get_processing_settings()
        tuning = processing.get("auto_tuning", {})
        self.chunk_size = processing.get("ram_chunk_size", 100)
        self.monitor = MultiPassResourceMonitor(
            chunk_size=self.chunk_size,
            min_chunk=tuning.get("min_ram_chunk_size", 10),
            max_chunk=tuning.get("max_ram_chunk_size", 500),
            memory_limit_percent=tuning.get("memory_limit_percent", 85),
            model_manager=self.models,
        )
        self.phase_times = {"io": 0.0, "model_load": 0.0, "inference": 0.0,
                            "unload": 0.0, "aggregate": 0.0, "save": 0.0}
        self.selected_models = None
        self.passes = None
        self._resolved = {}       # requested model name -> loaded name/None
        self._update_only = None  # single-pass: columns allowed to overwrite
        self.load_errors = {}     # path -> decode failure reason

    # -------------------------------------------------------------- planning

    def detect_and_configure(self, verbose=True):
        memory = self.models.memory_gb
        self.selected_models = self.models.select_models(self.config)
        self._refuse_unrunnable()
        self.passes = self.models.group_passes(self.selected_models)
        if verbose:
            mode = f"{memory:.1f} GB on {self.models.device}" if memory > 0 else "CPU mode"
            print(f"multi-pass: {mode}, models {self.selected_models}, "
                  f"{len(self.passes)} pass(es): {self.passes}")
        return self.passes

    def _refuse_unrunnable(self):
        """Raise NotImplementedError before any chunk when the selection holds
        a member this install would make the port run differently from the
        JAX package: the faces member with a converted 2d106det landmark
        graph installed. The load fallback below would skip it, writing "no
        face" rows (and, in --pass faces, over stored face columns)."""
        if "insightface" in self.selected_models:
            from facet_tpu_torch.models.face_pipeline import check_no_landmark_graph

            check_no_landmark_graph()

    # ------------------------------------------------------------- chunk IO

    def _load_chunk(self, paths):
        """Decode + EXIF for one chunk. Returns (paths, images, pils, exif).

        JPEGs decode through the native parallel decoder when built
        (native/facet_io.cpp); everything else (PNG/RAW/decoder-less builds)
        takes the PIL path.
        """
        from PIL import Image as PILImage

        from facet_tpu_torch.utils import native_decode

        t0 = time.time()
        images, pils, ok = [], [], []
        jpeg_idx = [i for i, p in enumerate(paths)
                    if p.lower().endswith((".jpg", ".jpeg"))]
        native = None
        if jpeg_idx and native_decode.available():
            native = dict(zip(jpeg_idx, native_decode.decode_jpeg_batch(
                [paths[i] for i in jpeg_idx]) or []))
        for i, path in enumerate(paths):
            arr = native.get(i) if native else None
            if arr is not None:
                pil = PILImage.fromarray(arr)
            else:
                pil = load_image(path)
                if pil is None:
                    self.load_errors[path] = "failed to decode"
                    print(f"  skip {os.path.basename(path)}: failed to decode")
                    continue
                arr = np.asarray(pil, dtype=np.uint8)
            if arr.ndim != 3 or arr.shape[2] != 3 or min(arr.shape[:2]) < 3:
                self.load_errors[path] = f"unsupported shape {arr.shape}"
                print(f"  skip {os.path.basename(path)}: "
                      f"unsupported shape {arr.shape}")
                continue
            ok.append(path)
            images.append(arr)
            pils.append(pil)
        exif = get_exif_batch(ok) if ok else {}
        self.phase_times["io"] += time.time() - t0
        return ok, images, pils, exif

    # ---------------------------------------------------------------- passes

    def _load_with_fallback(self, name):
        """Load a model, walking its unavailability fallback chain.

        The requested->actual resolution is cached so an unavailable
        model's chain (and its warnings) only walks once per run, and so
        _unload_pass_group can unload the model that ACTUALLY loaded —
        unloading by requested name leaves a fallback resident in HBM
        across later bin-packed passes (round-4 review finding)."""
        if name in self._resolved:
            actual = self._resolved[name]
            if actual is None:
                return None, None
            return actual, self.models.load_model(actual)
        chain = [name] + FALLBACK_CHAINS.get(name, [])
        for candidate in chain:
            try:
                model = self.models.load_model(candidate)
                self._resolved[name] = candidate
                return candidate, model
            except Exception as exc:
                tail = FALLBACK_CHAINS.get(candidate, [])
                nxt = f"; trying {tail[0]}" if tail else "; skipping"
                print(f"  pass {candidate}: unavailable ({exc}){nxt}")
        self._resolved[name] = None
        return None, None

    def _run_pass_group(self, group, state):
        """The members of a pass group that did not ride the fused pass."""
        for requested in group:
            # members the rider path already served need no load here
            if requested in QUALITY_PASS_MODELS and state.get("topiq") is not None:
                continue
            if requested == "samp_net" and state.get("samp") is not None:
                continue
            t0 = time.time()
            name, model = self._load_with_fallback(requested)
            if model is None:
                continue
            self.phase_times["model_load"] += time.time() - t0
            t0 = time.time()
            if name in QUALITY_PASS_MODELS:
                state["topiq"] = model.score_batch(state["images"])
                state["quality_model"] = name
            elif name == "samp_net":
                state["samp"] = model.score_batch(state["images"])
            elif name == "insightface":
                state["faces"] = model.analyze_batch(
                    state["images"], detections=state.pop("face_detections", None))
            self.phase_times["inference"] += time.time() - t0

    def _run_fused_clip_pass(self, group, state):
        """The clip slot of one pass group: the fused pass (aesthetic,
        embedding, pHash, technical statistics), with the group's other
        members riding the same resident batch: SCRFD's detection through
        the face pipeline (the faces step then reuses the detections from
        state["face_detections"]), TOPIQ and SAMP-Net as riders."""
        face_model = None
        if "insightface" in group:
            t0 = time.time()
            name, face_model = self._load_with_fallback("insightface")
            if name != "insightface":
                face_model = None
            self.phase_times["model_load"] += time.time() - t0
        riders, rider_names = {}, {}
        for requested in group:
            slot = ("quality" if requested in QUALITY_PASS_MODELS
                    else "samp" if requested == "samp_net" else None)
            if slot is None or slot in riders:
                continue
            t0 = time.time()
            name, model = self._load_with_fallback(requested)
            self.phase_times["model_load"] += time.time() - t0
            if model is not None and hasattr(model, "rider"):
                riders[slot] = model
                rider_names[slot] = name
        t0 = time.time()
        outputs, detections, rider_out = self.scorer._fused_scorer().score_images(
            state["images"], face_pipeline=face_model, riders=riders)
        if face_model is not None:
            state["face_detections"] = detections
        if "quality" in rider_out:
            state["topiq"] = rider_out["quality"]
            state["quality_model"] = rider_names["quality"]
        if "samp" in rider_out:
            state["samp"] = rider_out["samp"]
        state["tech"] = [self.scorer.technical.metrics_from_stats(o[3])
                         for o in outputs]
        state["phash"] = [o[2] for o in outputs]
        state["aesthetics"] = [(o[0], o[1]) for o in outputs]
        self.phase_times["inference"] += time.time() - t0

    def _unload_pass_group(self, group):
        t0 = time.time()
        for name in group:
            self.models.unload_model(self._resolved.get(name) or name)
            if name == "clip":
                self.scorer.release_fused()
        self.phase_times["unload"] += time.time() - t0

    # ----------------------------------------------------------- chunk logic

    def _device_prepass(self, state):
        """Technical statistics and pHash for a pass without clip."""
        t0 = time.time()
        fast = (bool(self.config.get_processing_settings().get(
            "fast_color_harmony", False))
            or self.config.speed_tier() == "fast")
        device = self.models.device
        stats = compute_batch_stats(state["images"], device,
                                    hs_subsample=4 if fast else 1)
        state["tech"] = [self.scorer.technical.metrics_from_stats(s) for s in stats]
        state["phash"] = phash_batch(state["images"], device)
        self.phase_times["inference"] += time.time() - t0

    # ---------------------------------------------------------------- public

    def process_directory(self, paths, verbose=True):
        """Score a list of paths chunk by chunk. Returns processed count.

        Host decode for chunk N+1 runs on a background thread while chunk N
        occupies the device (double-buffered ingest).
        """
        from concurrent.futures import ThreadPoolExecutor

        if self.passes is None:
            self.detect_and_configure(verbose=verbose)
        reporter = MetricsReporter(len(paths), label="multi-pass scan")
        self.monitor.chunk_size = self.chunk_size
        self.monitor.start()
        processed = 0
        executor = ThreadPoolExecutor(max_workers=1)
        try:
            pos = 0
            pending = None
            while pos < len(paths) or pending is not None:
                if pending is None:
                    size = max(1, self.monitor.chunk_size)
                    chunk = paths[pos:pos + size]
                    pos += len(chunk)
                    pending = executor.submit(self._load_chunk, chunk)
                loaded = pending.result()
                pending = None
                if pos < len(paths):
                    size = max(1, self.monitor.chunk_size)
                    nxt = paths[pos:pos + size]
                    pos += len(nxt)
                    pending = executor.submit(self._load_chunk, nxt)
                processed += self._process_loaded_chunk(*loaded)
                reporter.update(processed=processed)
        finally:
            executor.shutdown(wait=False)
            self.monitor.stop()
        if verbose:
            reporter.summary(self.phase_times, self.models.cache_stats())
        return processed

    def _process_loaded_chunk(self, ok, images, pils, exif):
        """Device passes + aggregation + save over a pre-decoded chunk."""
        if not ok:
            return 0
        n = len(ok)
        state = {"paths": ok, "images": images, "pils": pils,
                 "aesthetics": [(None, None)] * n, "faces": [None] * n,
                 "topiq": None, "samp": None}
        uses_clip = any("clip" in group for group in self.passes)
        if not uses_clip:
            self._device_prepass(state)
        multiple_passes = len(self.passes) > 1
        for group in self.passes:
            # the fused pass runs inside its bin-packed group, so its device
            # share is resident only while that group runs
            if "clip" in group:
                self._run_fused_clip_pass(group, state)
            self._run_pass_group([m for m in group if m != "clip"], state)
            if multiple_passes:
                self._unload_pass_group(group)

        t0 = time.time()
        tag_lists = [[] for _ in range(n)]
        if self.config.get_tagging_settings().get("enabled", True):
            blobs = [b for _, b in state["aesthetics"]]
            if any(b is not None for b in blobs):
                present = [b for b in blobs if b is not None]
                tagged = iter(self.scorer.tagger.tag_embedding_bytes(present))
                tag_lists = [next(tagged) if b is not None else [] for b in blobs]

        # chunk thumbnails through the native threaded encoder when built;
        # per-image PIL inside assemble_row otherwise
        from facet_tpu_torch.utils import native_decode

        thumbs = native_decode.encode_thumbnail_batch(
            images, self.scorer.thumb_size, self.scorer.thumb_quality)
        if thumbs is None:
            thumbs = [None] * n

        rows = []
        for i, path in enumerate(ok):
            rows.append(self.scorer.assemble_row(
                path, images[i], pils[i], exif.get(path, {}), state["tech"][i],
                state["phash"][i], state["aesthetics"][i], state["faces"][i],
                tag_lists[i],
                quality_score=None if state["topiq"] is None else state["topiq"][i],
                quality_model=state.get("quality_model"),
                samp_result=None if state["samp"] is None else state["samp"][i],
                thumbnail=thumbs[i]))
        self.phase_times["aggregate"] += time.time() - t0

        t0 = time.time()
        self.scorer.save_photos_batch(rows, update_only=self._update_only)
        self.phase_times["save"] += time.time() - t0
        return n

    def run_single_pass(self, paths, pass_name, verbose=True):
        """--pass quality|tags|composition|faces|embeddings over paths.

        Existing rows only have the pass's own columns (plus the
        always-recomputed prepass columns) overwritten; aggregates and
        categories then recompute from the merged rows."""
        if pass_name not in PASS_NAMES:
            raise ValueError(f"unknown pass '{pass_name}' "
                             f"(choose from {sorted(PASS_NAMES)})")
        self.selected_models = list(PASS_NAMES[pass_name])
        self._refuse_unrunnable()
        self.passes = self.models.group_passes(self.selected_models)
        if verbose:
            print(f"single pass '{pass_name}': models {self.selected_models}, "
                  f"passes {self.passes} on {self.models.device}")
        allowed = set(PREPASS_COLUMNS)
        for m in self.selected_models:
            allowed.update(MODEL_COLUMNS.get(m, ()))
            for fb in FALLBACK_CHAINS.get(m, ()):
                allowed.update(MODEL_COLUMNS.get(fb, ()))
        self._update_only = allowed
        try:
            done = self.process_directory(paths, verbose=verbose)
        finally:
            self._update_only = None
        if done:
            self.scorer.update_all_aggregates(
                [os.path.abspath(p) for p in paths], verbose=verbose)
        return done
