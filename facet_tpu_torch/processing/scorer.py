"""Facet: the scoring engine, on the port.

Counterpart of ``facet_tpu/processing/scorer.py`` for the methods the
default scan and the ``--pass`` scans run: the fused scorer, the CLIP
tagger, row assembly (the aggregate is computed last, from every model
output, SAMP-Net's composition and the face block included),
one-transaction batch persistence with the ``faces`` table, the aggregate
recompute over stored rows, the already-scanned set and the tag backfill
from stored embeddings. Row assembly, persistence and the recompute are
the JAX package's code, carried over; the device parts are the port's.

Host code (database, config, thumbnails, tags, the scoring brain and the
composition analyzer) comes from the port's own copies of the JAX package's
host modules.
"""

import os

from facet_tpu_torch.analyzers.composition import CompositionAnalyzer
from facet_tpu_torch.analyzers.technical import TechnicalAnalyzer, recompute_exposure_score
from facet_tpu_torch.config.scoring_config import ScoringConfig
from facet_tpu_torch.db.connection import get_connection
from facet_tpu_torch.db.schema import init_database
from facet_tpu_torch.db.tags import sync_photo_tags
from facet_tpu_torch.models.model_manager import ModelManager
from facet_tpu_torch.scoring.brain import calculate_aggregate, determine_photo_category
from facet_tpu_torch.scoring.vectorized import AggregateScorer
from facet_tpu_torch.utils.tags import tags_to_string
from facet_tpu_torch.utils.thumbnails import make_thumbnail

# Columns written by save_photos_batch, in insert order.
ROW_COLUMNS = [
    "path", "filename", "date_taken", "camera_model", "lens_model", "iso",
    "f_stop", "shutter_speed", "focal_length", "focal_length_35mm",
    "image_width", "image_height", "aesthetic", "face_count", "face_quality",
    "eye_sharpness", "face_sharpness", "face_ratio", "tech_sharpness",
    "color_score", "exposure_score", "comp_score", "isolation_bonus",
    "aggregate", "is_blink", "is_monochrome", "is_silhouette",
    "is_group_portrait", "is_burst_lead", "clip_embedding",
    "raw_sharpness_variance", "histogram_data", "histogram_spread",
    "mean_luminance", "histogram_bimodality", "power_point_score",
    "raw_color_entropy", "raw_eye_sharpness", "shadow_clipped",
    "highlight_clipped", "dynamic_range_stops", "noise_sigma",
    "contrast_score", "mean_saturation", "leading_lines_score",
    "face_confidence", "thumbnail", "phash", "config_version", "tags",
    "quality_score", "topiq_score", "composition_explanation",
    "scoring_model", "composition_pattern", "category",
]


def resolve_profile(config, memory_gb):
    """Resolve ``models.vram_profile: auto`` from the card's memory.

    Stands in for ScoringConfig.check_vram_profile_compatibility, which
    asks jax for a TPU's memory: the port passes the card's total memory
    (or nothing in CPU mode, which selects the legacy profile)."""
    models = config.get_model_config()
    if models.get("vram_profile", "legacy") != "auto":
        return models["vram_profile"]
    if memory_gb > 0:
        profile = ScoringConfig.suggest_hardware_profile(memory_gb=memory_gb)[0]
    else:
        profile = "legacy"
    config.config.setdefault("models", {})["vram_profile"] = profile
    return profile


class Facet:
    """Scoring engine bound to one database + one scoring config."""

    def __init__(self, db_path="photo_scores_pro.db", config=None,
                 config_path=None, model_manager=None, device=None):
        self.db_path = db_path
        init_database(db_path)
        self.config = config or ScoringConfig(config_path)
        self.models = model_manager or ModelManager(self.config, device=device)
        self.device = self.models.device
        resolve_profile(self.config, self.models.memory_gb)

        self.technical = TechnicalAnalyzer(self.config)
        self.composition = CompositionAnalyzer(self.config)
        self._tagger = None
        self._aggregate_scorer = None
        self._fused = None

        processing = self.config.get_processing_settings()
        thumbs = processing.get("thumbnails", {})
        self.thumb_size = thumbs.get("photo_size", 640)
        self.thumb_quality = thumbs.get("photo_quality", 80)

    # ------------------------------------------------------------ lazy deps

    @property
    def aesthetic_model(self):
        """CLIP + aesthetic head (loaded on demand)."""
        return self.models.load_model("clip")

    @property
    def tagger(self):
        if self._tagger is None:
            from facet_tpu_torch.models.tagger import CLIPTagger

            self._tagger = CLIPTagger(self.config, device=self.device)
        return self._tagger

    @property
    def aggregate_scorer(self):
        if self._aggregate_scorer is None:
            self._aggregate_scorer = AggregateScorer(self.config, device=self.device)
        return self._aggregate_scorer

    def _fused_scorer(self):
        if self._fused is None:
            from facet_tpu_torch.processing.device_pipeline import FusedScorer

            fast = (bool(self.config.get_processing_settings().get(
                "fast_color_harmony", False))
                or self.config.speed_tier() == "fast")
            self._fused = FusedScorer(self.aesthetic_model,
                                      hs_subsample=4 if fast else 1)
        return self._fused

    def release_fused(self):
        """Drop the fused scorer's device references so unloading 'clip'
        frees its memory."""
        self._fused = None

    # --------------------------------------------------------------- scoring

    def assemble_row(self, path, image, pil, exif, tech, phash,
                     aesthetic_pair, faces, tag_hits, quality_score=None,
                     quality_model=None, samp_result=None, thumbnail=None):
        """Build one photos row, computing the aggregate LAST so every model
        output influences it. When a quality (NR-IQA) model ran, its score
        replaces the CLIP aesthetic in the aggregate, as in the reference
        (processing/scorer.py:1755-1765 update_quality_scores); a SAMP-Net
        result replaces the rule-based comp_score the same way. ``faces``
        is the face pipeline's photo-level dict (None when it did not run);
        its per-face rows ride along under ``_faces``."""
        h, w = image.shape[:2]
        aesthetic, embedding = aesthetic_pair
        if quality_score is not None:
            aesthetic = quality_score

        m = dict(tech)
        m["aesthetic"] = aesthetic
        m["iso"] = exif.get("iso")
        m["f_stop"] = exif.get("f_stop")
        m["shutter_speed"] = exif.get("shutter_speed")
        m["focal_length"] = exif.get("focal_length")
        m["tags"] = tags_to_string(tag_hits)

        group_min = self.config.get_face_detection_settings().get("min_faces_for_group", 4)
        if faces:
            m.update({
                "face_count": faces["face_count"],
                "face_quality": faces["face_quality"],
                "eye_sharpness": faces["eye_sharpness"],
                "face_sharpness": faces["face_sharpness"],
                "face_ratio": faces["face_ratio"],
                "is_blink": faces["is_blink"],
                "face_confidence": faces.get("confidence"),
                "raw_eye_sharpness": faces.get("raw_eye_sharpness"),
            })
            m["is_group_portrait"] = 1 if faces["face_count"] >= group_min else 0
            face_bbox = faces.get("combined_bbox")
        else:
            m.update({"face_count": 0, "face_quality": None, "eye_sharpness": None,
                      "face_sharpness": None, "face_ratio": 0.0, "is_blink": 0,
                      "face_confidence": None, "raw_eye_sharpness": None,
                      "is_group_portrait": 0})
            face_bbox = None

        composition_pattern = None
        if samp_result is not None:
            m["comp_score"] = samp_result["score"]
            m["power_point_score"] = samp_result.get("power_point_score")
            m["leading_lines_score"] = None
            composition_pattern = samp_result.get("pattern")
        else:
            comp = self.composition.analyze(image, face_bbox)
            m["comp_score"] = CompositionAnalyzer.integrate_leading_lines(
                comp["score"], comp["leading_lines_score"], bool(face_bbox))
            m["power_point_score"] = comp["power_point_score"]
            m["leading_lines_score"] = comp["leading_lines_score"]

        m["isolation_bonus"] = 1.0
        aggregate, category = calculate_aggregate(m, self.config)

        if quality_score is not None:
            scoring_model = quality_model or "quality"
        else:
            scoring_model = "clip-mlp" if aesthetic is not None else None
        row = {
            "path": path,
            "filename": os.path.basename(path),
            "date_taken": exif.get("date_taken"),
            "camera_model": exif.get("camera_model"),
            "lens_model": exif.get("lens_model"),
            "iso": exif.get("iso"),
            "f_stop": exif.get("f_stop"),
            "shutter_speed": exif.get("shutter_speed"),
            "focal_length": exif.get("focal_length"),
            "focal_length_35mm": exif.get("focal_length_35mm"),
            "image_width": exif.get("image_width") or w,
            "image_height": exif.get("image_height") or h,
            "aesthetic": aesthetic,
            "face_count": m["face_count"],
            "face_quality": m["face_quality"],
            "eye_sharpness": m["eye_sharpness"],
            "face_sharpness": m["face_sharpness"],
            "face_ratio": m["face_ratio"],
            "tech_sharpness": tech["tech_sharpness"],
            "color_score": tech["color_score"],
            "exposure_score": tech["exposure_score"],
            "comp_score": m["comp_score"],
            "isolation_bonus": m["isolation_bonus"],
            "aggregate": round(aggregate, 2),
            "is_blink": m["is_blink"],
            "is_monochrome": tech["is_monochrome"],
            "is_silhouette": tech["is_silhouette"],
            "is_group_portrait": m["is_group_portrait"],
            "is_burst_lead": 1,  # bursts re-flag after the scan
            "clip_embedding": embedding,
            "raw_sharpness_variance": tech["raw_sharpness_variance"],
            "histogram_data": tech["histogram_data"],
            "histogram_spread": tech["histogram_spread"],
            "mean_luminance": tech["mean_luminance"],
            "histogram_bimodality": tech["histogram_bimodality"],
            "power_point_score": m["power_point_score"],
            "raw_color_entropy": tech["raw_color_entropy"],
            "raw_eye_sharpness": m["raw_eye_sharpness"],
            "shadow_clipped": tech["shadow_clipped"],
            "highlight_clipped": tech["highlight_clipped"],
            "dynamic_range_stops": tech["dynamic_range_stops"],
            "noise_sigma": tech["noise_sigma"],
            "contrast_score": tech["contrast_score"],
            "mean_saturation": tech["mean_saturation"],
            "leading_lines_score": m["leading_lines_score"],
            "face_confidence": m["face_confidence"],
            # the chunk path encodes thumbnails through the native threaded
            # encoder when it is built; PIL per image otherwise
            "thumbnail": thumbnail if thumbnail is not None else
                         make_thumbnail(pil, self.thumb_size,
                                        self.thumb_quality),
            "phash": phash,
            "config_version": self.config.version_hash,
            "tags": m["tags"],
            "quality_score": quality_score,
            "topiq_score": quality_score,
            "composition_explanation": None,
            "scoring_model": scoring_model,
            "composition_pattern": composition_pattern,
            "category": category,
            "_faces": faces["rows"] if faces else [],
        }
        return row

    # ------------------------------------------------------------ persistence

    def save_photos_batch(self, rows, update_only=None):
        """Single-transaction batch insert, face rows and tag sync.

        Uses an UPSERT, NOT the reference's INSERT OR REPLACE
        (processing/scorer.py:1621): REPLACE deletes the conflicting row
        first, and with PRAGMA foreign_keys=ON that delete CASCADES —
        silently destroying the photo's comparison votes, duplicate pairs,
        recommendation history, and face person assignments on every
        --force rescan (the reference has exactly this data-loss bug; a
        deliberate divergence, pinned in tests/test_db.py). Column values
        written are identical to REPLACE semantics.

        update_only: optional iterable of column names — an EXISTING row then
        only has those columns overwritten (single-pass semantics: models
        that did not run must not clobber stored scores); new rows insert in
        full.
        """
        if not rows:
            return 0
        cols = ", ".join(ROW_COLUMNS)
        placeholders = ", ".join("?" for _ in ROW_COLUMNS)
        writable = [c for c in ROW_COLUMNS if c != "path"]
        if update_only is not None:
            keep = set(update_only)
            writable = [c for c in writable if c in keep]
        sets = ", ".join(f"{c} = excluded.{c}" for c in writable)
        sql = (f"INSERT INTO photos ({cols}) VALUES ({placeholders}) "
               f"ON CONFLICT(path) DO UPDATE SET {sets}")
        sync_tags = update_only is None or "tags" in set(update_only)
        with get_connection(self.db_path) as conn:
            for row in rows:
                conn.execute(sql, [row.get(c) for c in ROW_COLUMNS])
                if sync_tags:
                    sync_photo_tags(conn, row["path"], row.get("tags"))
                faces = row.get("_faces") or []
                if faces:
                    conn.execute("DELETE FROM faces WHERE photo_path = ?", (row["path"],))
                    conn.executemany(
                        "INSERT OR REPLACE INTO faces (photo_path, face_index, embedding,"
                        " bbox_x1, bbox_y1, bbox_x2, bbox_y2, confidence,"
                        " face_thumbnail, landmark_2d_106)"
                        " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                        [(row["path"], f["face_index"], f["embedding"],
                          f["bbox"][0], f["bbox"][1], f["bbox"][2], f["bbox"][3],
                          f["confidence"], f.get("thumbnail"), f.get("landmarks"))
                         for f in faces])
        return len(rows)

    def update_columns(self, updates):
        """{path: {column: value}} partial update."""
        if not updates:
            return
        with get_connection(self.db_path) as conn:
            for path, fields in updates.items():
                cols = ", ".join(f"{c} = ?" for c in fields)
                conn.execute(f"UPDATE photos SET {cols} WHERE path = ?",
                             list(fields.values()) + [path])
                if "tags" in fields:
                    sync_photo_tags(conn, path, fields["tags"])

    def get_already_scanned_set(self):
        with get_connection(self.db_path) as conn:
            return {r[0] for r in conn.execute(
                "SELECT path FROM photos WHERE aggregate IS NOT NULL")}

    # ------------------------------------------------------------- recompute

    def update_all_aggregates(self, paths, verbose=False):
        """Re-score ``paths`` from their stored raw data (no image IO), after
        a single pass merged its columns into existing rows.

        Vectorized path: one device call for the aggregate math over all
        rows. The stored aesthetic is kept (a single pass wrote it). Percentile
        normalization still derives its scales from the WHOLE library
        (PercentileNormalizer reads the DB itself). Thumbnails are
        excluded from the load — the recompute never reads them and at
        library scale they dominate the SELECT * memory cost.
        """
        cols = ", ".join(c for c in ROW_COLUMNS if c != "thumbnail")
        rows = []
        chunk = sorted(paths)
        with get_connection(self.db_path) as conn:
            for start in range(0, len(chunk), 500):
                part = chunk[start:start + 500]
                marks = ", ".join("?" for _ in part)
                rows.extend(dict(r) for r in conn.execute(
                    f"SELECT {cols} FROM photos WHERE path IN ({marks})", part))
        if not rows:
            return 0

        group_min = self.config.get_face_detection_settings().get("min_faces_for_group", 4)

        # percentile normalization: re-derive scale-dependent scores from the
        # stored raw metrics against the library's current percentiles
        # (reference: config/percentile_normalizer.py via scorer.py:1148+)
        normalizer = None
        if self.config.get_normalization_settings().get("method") == "percentile":
            from facet_tpu_torch.config.percentile_normalizer import PercentileNormalizer

            normalizer = PercentileNormalizer(self.db_path, self.config)
            normalizer.compute_percentiles()
            if normalizer.per_category:
                normalizer.compute_percentiles_per_category()

        # Reference semantics (processing/scorer.py:1199-1283, parity-tested
        # in tests/test_reference_parity.py::TestRecomputeParity):
        # normalization is TRANSIENT (feeds the aggregate, never persisted),
        # uses the category determined from the stored row (before the
        # group-portrait refresh), covers exactly the three raw->score
        # metrics, and is unrounded; the exposure refresh keeps the STORED
        # bimodality/silhouette/clipping flags and recomputes only the
        # score; only aggregate / category / is_group_portrait /
        # exposure_score / config_version are written back.
        recompute_metrics = {"raw_sharpness_variance": "tech_sharpness",
                             "raw_color_entropy": "color_score",
                             "raw_eye_sharpness": "eye_sharpness"}
        for row in rows:
            if normalizer is not None and normalizer.ready():
                category0 = determine_photo_category(row, self.config)
                for raw_col, score_col in recompute_metrics.items():
                    value = row.get(raw_col)
                    if value is None or not isinstance(value, (int, float)):
                        continue
                    normalized = normalizer.normalize(
                        raw_col, value,
                        category=category0 if normalizer.per_category else None)
                    if normalized is not None:
                        row[score_col] = normalized
            fc = row.get("face_count") or 0
            row["is_group_portrait"] = 1 if fc >= group_min else 0
            refreshed = recompute_exposure_score(
                row.get("histogram_data"),
                row.get("histogram_bimodality"), row.get("is_silhouette", 0))
            if refreshed is not None:
                row["exposure_score"] = refreshed

        scores, categories = self.aggregate_scorer.score_rows(rows)

        with get_connection(self.db_path) as conn:
            conn.executemany(
                "UPDATE photos SET aggregate = ?, config_version = ?,"
                " category = ?, is_group_portrait = ?, exposure_score = ?"
                " WHERE path = ?",
                [(round(float(scores[i]), 2), self.config.version_hash,
                  categories[i], rows[i].get("is_group_portrait"),
                  # a recomputed 0.0 is a legitimate worst-exposure value —
                  # `or 5.0` would silently bump it (reference keeps 0.0:
                  # scorer.py:1276)
                  round(5.0 if rows[i].get("exposure_score") is None
                        else float(rows[i]["exposure_score"]), 4),
                  rows[i]["path"])
                 for i in range(len(rows))])
        if verbose:
            print(f"recomputed aggregates for {len(rows)} photos")
        return len(rows)

    def retag_from_embeddings(self, only_untagged=True, verbose=False):
        """Re-run zero-shot tagging from stored CLIP embeddings (no images)."""
        where = "clip_embedding IS NOT NULL"
        if only_untagged:
            where += " AND (tags IS NULL OR tags = '')"
        with get_connection(self.db_path) as conn:
            rows = conn.execute(
                f"SELECT path, clip_embedding FROM photos WHERE {where}").fetchall()
        if not rows:
            return 0
        blobs = [r["clip_embedding"] for r in rows]
        tag_lists = self.tagger.tag_embedding_bytes(blobs)
        updates = {r["path"]: {"tags": tags_to_string(t)}
                   for r, t in zip(rows, tag_lists)}
        self.update_columns(updates)
        if verbose:
            print(f"tagged {len(updates)} photos from stored embeddings")
        return len(updates)
