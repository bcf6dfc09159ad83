"""Vectorized aggregate scoring: re-score many rows in one device call.

Counterpart of ``facet_tpu/scoring/vectorized.py`` in plain PyTorch (no
kernel): category weights become a (C, 16) matrix, per-category modifiers
flag vectors, and every row scores as one gather + weighted reduction in
float32. Category routing (string tag matching) stays on the host through
``scoring/brain.py``, the port's copy of the JAX package's.
"""

import numpy as np
import torch

from facet_tpu_torch.scoring.brain import (
    FACE_CATEGORIES,
    METRIC_KEYS,
    _parse_iso,
    determine_photo_category,
    safe_float,
)

# Numeric per-photo inputs the device kernel consumes, with sanitize defaults.
FIELD_DEFAULTS = {
    "aesthetic": 5.0,
    "face_quality": 5.0,
    "eye_sharpness": 5.0,
    "face_sharpness": 5.0,
    "tech_sharpness": 5.0,
    "comp_score": 5.0,
    "power_point_score": 5.0,
    "exposure_score": 5.0,
    "color_score": 5.0,
    "contrast_score": 5.0,
    "mean_saturation": 0.5,
    "noise_sigma": 0.0,
    "histogram_bimodality": 0.0,
    "histogram_spread": 0.0,
    "leading_lines_score": 0.0,
}


class AggregateScorer:
    """Precompiles a config's category tables for batched device scoring."""

    def __init__(self, config, device="cpu"):
        self.config = config
        self.device = device
        self.category_names = config.get_all_category_names()
        self._index = {name: i for i, name in enumerate(self.category_names)}

        c = len(self.category_names)
        w_matrix = np.zeros((c, len(METRIC_KEYS)), np.float32)
        bonus = np.zeros(c, np.float32)
        apply_blink = np.zeros(c, np.float32)
        skip_clipping = np.zeros(c, np.float32)
        noise_tolerance = np.ones(c, np.float32)
        clipping_mult = np.ones(c, np.float32)
        skip_oversat = np.zeros(c, np.float32)
        aes_shift = np.zeros(c, np.float32)
        blend_lines = np.zeros(c, np.float32)

        for i, name in enumerate(self.category_names):
            w = config.get_weights(name)
            for j, key in enumerate(METRIC_KEYS):
                w_matrix[i, j] = w.get(key, 0.0)
            bonus[i] = w.get("bonus", 0.0)
            apply_blink[i] = float(bool(w.get("_apply_blink_penalty",
                                              name in FACE_CATEGORIES)))
            skip_clipping[i] = float(bool(w.get("_skip_clipping_penalty",
                                                name == "silhouette")))
            noise_tolerance[i] = w.get("noise_tolerance_multiplier", 1.0)
            clipping_mult[i] = w.get("_clipping_multiplier",
                                     1.5 if name == "default" else 1.0)
            skip_oversat[i] = float(bool(w.get("_skip_oversaturation_penalty",
                                               name in ("night", "astro", "concert"))))
            w_aes = w.get("aesthetic", 0.0)
            aes_shift[i] = (w.get("quality", 0.0) / max(w_aes, 0.01)) if w_aes > 0 else 0.0
            blend_lines[i] = float(name not in ("portrait", "group_portrait"))

        tables = {
            "w": w_matrix,
            "bonus": bonus,
            "apply_blink": apply_blink,
            "skip_clipping": skip_clipping,
            "noise_tolerance": noise_tolerance,
            "clipping_mult": clipping_mult,
            "skip_oversat": skip_oversat,
            "aes_shift": aes_shift,
            "blend_lines": blend_lines,
        }
        self.tables = {k: torch.as_tensor(v, device=device) for k, v in tables.items()}

        limits = config.get_scoring_limits()
        penalties = config.get_penalty_settings()
        exif = config.get_exif_adjustments()
        self.consts = {
            "score_min": limits["score_min"],
            "score_max": limits["score_max"],
            "blink_penalty": (config.get_threshold("blink_penalty_percent") or 50) / 100,
            "noise_threshold": penalties["noise_sigma_threshold"],
            "noise_max": penalties["noise_max_penalty_points"],
            "noise_rate": penalties["noise_penalty_per_sigma"],
            "bimod_threshold": penalties["bimodality_threshold"],
            "bimod_points": penalties["bimodality_penalty_points"],
            "oversat_threshold": penalties.get("oversaturation_threshold", 0.9),
            "oversat_points": penalties.get("oversaturation_penalty_points", 0.5),
            "lines_blend": penalties["leading_lines_blend_percent"] / 100,
            # reference_iso_parity reproduces the reference's effective
            # no-op ISO handling (see brain.calculate_aggregate)
            "iso_compensation": float(
                exif.get("iso_sharpness_compensation", True)
                and not exif.get("reference_iso_parity", False)),
            "aperture_boost": float(exif.get("aperture_isolation_boost", True)),
            "silhouette_detection": float(
                config.get_exposure_settings().get("silhouette_detection", True)),
        }

    def category_index(self, row):
        """Host-side category routing for one row dict -> int index."""
        return self._index[determine_photo_category(row, self.config)]

    def build_inputs(self, rows):
        """Sanitize a list of row dicts into the device input arrays."""
        n = len(rows)
        arrays = {key: np.empty(n, np.float32) for key in FIELD_DEFAULTS}
        extra = {key: np.empty(n, np.float32) for key in
                 ("iso", "f_stop", "isolation_bonus", "is_silhouette",
                  "shadow_clipped", "highlight_clipped", "is_monochrome", "is_blink")}
        category_idx = np.empty(n, np.int32)
        for i, row in enumerate(rows):
            for key, default in FIELD_DEFAULTS.items():
                arrays[key][i] = safe_float(row.get(key), default)
            # route through the brain's parsers so string EXIF ('3200',
            # '2.8') sanitizes identically in both aggregate paths
            iso = _parse_iso(row.get("iso"))
            extra["iso"][i] = iso if iso else 0.0
            f_stop = row.get("f_stop")
            if isinstance(f_stop, str):
                try:
                    f_stop = float(f_stop)
                except ValueError:
                    f_stop = None
            extra["f_stop"][i] = float(f_stop) if isinstance(f_stop, (int, float)) and f_stop > 0 else 0.0
            iso_b = row.get("isolation_bonus")
            extra["isolation_bonus"][i] = float(iso_b) if isinstance(iso_b, (int, float)) else 1.0
            for key in ("is_silhouette", "shadow_clipped", "highlight_clipped",
                        "is_monochrome", "is_blink"):
                extra[key][i] = 1.0 if row.get(key) else 0.0
            category_idx[i] = self.category_index(row)
        arrays.update(extra)
        return arrays, category_idx

    def score_rows(self, rows):
        """List of row dicts -> (scores float32 (N,), category names list)."""
        if not rows:
            return np.zeros(0, np.float32), []
        arrays, category_idx = self.build_inputs(rows)
        scores = score_values(*self._device_inputs(arrays, category_idx),
                              self.tables, self.consts)
        names = [self.category_names[i] for i in category_idx]
        return scores.cpu().numpy(), names

    def _device_inputs(self, arrays, category_idx):
        return ({k: torch.as_tensor(v, device=self.device) for k, v in arrays.items()},
                torch.as_tensor(category_idx, device=self.device).long())

    def metric_values(self, rows):
        """(N, 16) clamped metric-value matrix in METRIC_KEYS order.

        The per-metric inputs to the weighted sum — what the preference
        optimizer learns weights over.
        """
        if not rows:
            return np.zeros((0, len(METRIC_KEYS)), np.float32)
        arrays, category_idx = self.build_inputs(rows)
        values, _ = compute_values(*self._device_inputs(arrays, category_idx),
                                   self.tables, self.consts)
        return values.cpu().numpy()


def compute_values(a, cat, tables, c):
    """Shared metric-value computation -> ((N, 16) clamped values, penalties)."""
    f32 = dict(dtype=torch.float32, device=cat.device)

    def full(v):
        return torch.full_like(a["iso"], float(v))

    # EXIF adjustments
    iso = a["iso"]
    sharp = a["tech_sharpness"]
    iso_boost = torch.where(
        (iso > 800) & (c["iso_compensation"] > 0),
        0.5 * torch.log2(torch.clamp(iso, min=801.0) / 800.0), full(0.0))
    adjusted_sharpness = torch.clamp(sharp + iso_boost, max=10.0)

    f_stop = a["f_stop"]
    iso_bonus = a["isolation_bonus"]
    mult = torch.where(f_stop <= 2.0, full(1.5),
                       torch.where(f_stop <= 2.8, full(1.3), full(1.0)))
    mult = torch.where((f_stop > 0) & (c["aperture_boost"] > 0), mult, full(1.0))
    effective_isolation = torch.clamp(iso_bonus * mult, max=3.0)
    isolation_score = torch.clamp((effective_isolation - 1.0) * 5.0, max=10.0)

    is_sil = a["is_silhouette"] * c["silhouette_detection"]
    clipping_penalty = torch.where(
        is_sil > 0, full(0.0),
        a["shadow_clipped"] * 0.5 + a["highlight_clipped"] * 1.0)

    dynamic_range_score = torch.clamp(a["histogram_spread"] / 6.0, max=10.0)

    noise_sigma = a["noise_sigma"]
    noise_penalty = torch.where(
        noise_sigma > c["noise_threshold"],
        torch.clamp((noise_sigma - c["noise_threshold"]) * c["noise_rate"],
                    max=c["noise_max"]),
        full(0.0))
    bimod_penalty = torch.where(
        a["histogram_bimodality"] > c["bimod_threshold"], full(c["bimod_points"]),
        full(0.0))
    oversat_penalty = torch.where(
        a["mean_saturation"] > c["oversat_threshold"], full(c["oversat_points"]),
        full(0.0))
    leading_lines = torch.clamp(a["leading_lines_score"] * 1.77, max=10.0)

    col = torch.where(a["is_monochrome"] > 0, full(5.0), a["color_score"])
    blend = tables["blend_lines"][cat]
    comp = torch.where(
        (blend > 0) & (leading_lines > 0),
        torch.clamp(a["comp_score"] + leading_lines * c["lines_blend"], max=10.0),
        a["comp_score"])

    aes_value = a["aesthetic"] + tables["aes_shift"][cat]
    saturation = torch.clamp(a["mean_saturation"] * 10.0, max=10.0)
    noise_score = torch.clamp(10.0 - noise_sigma * 0.7, 0.0, 10.0)

    # metric value matrix in METRIC_KEYS order
    values = torch.stack([
        aes_value,
        torch.zeros_like(aes_value),          # quality
        a["face_quality"],
        a["face_sharpness"],
        a["eye_sharpness"],
        adjusted_sharpness,
        comp,
        a["power_point_score"],
        leading_lines,
        a["exposure_score"],
        col,
        a["contrast_score"],
        dynamic_range_score,
        saturation,
        noise_score,
        isolation_score,
    ], dim=1).to(**f32)                       # (N, 16)

    penalties = {
        "clipping": clipping_penalty,
        "noise": noise_penalty,
        "bimodality": bimod_penalty,
        "oversaturation": oversat_penalty,
    }
    return torch.clamp(values, 0.0, 10.0), penalties


def score_values(a, cat, tables, c):
    """(N,) float32 aggregate scores."""
    clamped, pen = compute_values(a, cat, tables, c)
    zero = torch.zeros_like(clamped[:, 0])

    w = tables["w"][cat]                      # (N, 16)
    score = torch.sum(torch.where(w > 0, clamped * w, torch.zeros_like(w)), dim=1)

    blink = tables["apply_blink"][cat] * a["is_blink"]
    score = torch.where(blink > 0, score * c["blink_penalty"], score)
    score = score + tables["bonus"][cat]
    score = score - torch.where(
        tables["skip_clipping"][cat] > 0, zero,
        pen["clipping"] * tables["clipping_mult"][cat])
    score = score - pen["noise"] * tables["noise_tolerance"][cat]
    score = score - pen["bimodality"]
    score = score - torch.where(tables["skip_oversat"][cat] > 0, zero,
                                pen["oversaturation"])
    return torch.clamp(score, c["score_min"], c["score_max"])
