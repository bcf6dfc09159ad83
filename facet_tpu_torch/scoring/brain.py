"""The aggregate score: reference-parity scalar implementation.

Combines the 16 metric signals into one 0-10 score using the matched
category's weights, with EXIF-aware adjustments and penalty terms. Semantics
follow the reference's "THE BRAIN" exactly (processing/scorer.py:769-950):

1. ISO-aware sharpness compensation: above ISO 800, add 0.5*log2(iso/800),
   capped at 10.
2. Aperture isolation boost: f<=2.0 -> x1.5, f<=2.8 -> x1.3, cap 3.0; the
   isolation score is (bonus-1)*5 on a 0-10 scale.
3. Clipping penalty (skipped for silhouettes): shadow*0.5 + highlight*1.0,
   times a per-category multiplier (default category: 1.5).
4. Dynamic range score = histogram spread / 6, capped at 10.
5. Noise penalty above sigma threshold, bimodality penalty, oversaturation
   penalty (each config-driven, each category-modifiable).
6. Monochrome photos get neutral color score 5.0.
7. Leading lines blend into composition for non-portrait categories.
8. Weighted sum over the category's weight vector, blink multiplier for face
   categories, category bonus, clamp to [score_min, score_max].
"""

import numpy as np

METRIC_KEYS = [
    "aesthetic", "quality", "face_quality", "face_sharpness", "eye_sharpness",
    "tech_sharpness", "composition", "power_point", "leading_lines",
    "exposure", "color", "contrast", "dynamic_range", "saturation", "noise",
    "isolation",
]

FACE_CATEGORIES = ("portrait", "portrait_bw", "group_portrait")


def safe_float(val, default=5.0):
    """Sanitize a metric value from the DB: BLOBs, strings and absurd numbers
    fall back to the default."""
    if val is None or isinstance(val, bytes):
        return default
    if isinstance(val, str):
        try:
            val = float(val)
        except ValueError:
            return default
    if isinstance(val, bool):
        return float(val)
    if isinstance(val, (int, float)):
        if val < -100 or val > 100:
            return default
        return float(val)
    return default


def parse_shutter_speed(val):
    """'1/500' -> 0.002; numbers pass through; unparseable -> None."""
    if val is None:
        return None
    if isinstance(val, (int, float)):
        return float(val)
    if isinstance(val, str):
        try:
            if "/" in val:
                num, denom = val.split("/")
                return float(num) / float(denom)
            return float(val)
        except (ValueError, ZeroDivisionError):
            return None
    return None


def _parse_iso(val):
    """ISO sensitivity as a positive float, or None."""
    if isinstance(val, str):
        try:
            val = float(val)
        except ValueError:
            return None
    if isinstance(val, (int, float)) and val > 0:
        return float(val)
    return None


def scoring_penalties(m, config):
    """Noise / bimodality / oversaturation penalties + leading-lines terms."""
    settings = config.get_penalty_settings() if config else {}

    noise_sigma = safe_float(m.get("noise_sigma"), 0)
    noise_threshold = settings.get("noise_sigma_threshold", 4.0)
    noise_penalty = 0.0
    if noise_sigma > noise_threshold:
        noise_penalty = min(
            settings.get("noise_max_penalty_points", 1.5),
            (noise_sigma - noise_threshold) * settings.get("noise_penalty_per_sigma", 0.3),
        )

    bimodality = safe_float(m.get("histogram_bimodality"), 0)
    bimodality_penalty = (
        settings.get("bimodality_penalty_points", 0.5)
        if bimodality > settings.get("bimodality_threshold", 2.5) else 0.0
    )

    mean_saturation = safe_float(m.get("mean_saturation"), 0)
    oversaturation_penalty = (
        settings.get("oversaturation_penalty_points", 0.5)
        if mean_saturation > settings.get("oversaturation_threshold", 0.9) else 0.0
    )

    return {
        "noise_penalty": noise_penalty,
        "noise_sigma": noise_sigma,
        "bimodality_penalty": bimodality_penalty,
        "oversaturation_penalty": oversaturation_penalty,
        "leading_lines": min(10.0, safe_float(m.get("leading_lines_score"), 0) * 1.77),
        "leading_lines_blend": settings.get("leading_lines_blend_percent", 30) / 100,
    }


def determine_photo_category(m, config):
    """Build the filter input dict from a metric/row mapping and ask the
    config for the first matching category."""
    def num(val, default=0.0):
        if val is None or isinstance(val, bytes):
            return default
        if isinstance(val, (int, float)):
            return float(val) if -100 <= val <= 100 else default
        return default

    photo_data = {
        "tags": m.get("tags", "") or "",
        "face_count": int(num(m.get("face_count"), 0)),
        "face_ratio": num(m.get("face_ratio"), 0),
        "is_silhouette": m.get("is_silhouette", 0),
        "is_group_portrait": m.get("is_group_portrait", 0),
        "is_monochrome": m.get("is_monochrome", 0),
        "mean_luminance": num(m.get("mean_luminance"), 0.5),
        "iso": m.get("iso"),
        "shutter_speed": parse_shutter_speed(m.get("shutter_speed")),
        "focal_length": m.get("focal_length"),
        "f_stop": m.get("f_stop"),
    }
    return config.determine_category(photo_data)


def calculate_aggregate(m, config):
    """Compute (aggregate_score, category) for one photo's metric dict."""
    limits = config.get_scoring_limits() if config else {}
    score_min = limits.get("score_min", 0.0)
    score_max = limits.get("score_max", 10.0)

    portrait_ratio = 0.05  # kept for parity; category filters use their own
    blink_penalty = 0.5
    if config:
        portrait_ratio = (config.get_threshold("portrait_face_ratio_percent") or 5) / 100
        blink_penalty = (config.get_threshold("blink_penalty_percent") or 50) / 100
    del portrait_ratio  # the category filters carry the ratio thresholds now

    exif = config.get_exif_adjustments() if config else {}

    # 1. ISO-aware sharpness compensation.
    # NOTE: the reference sanitizes ISO through its +-100 range filter
    # (processing/scorer.py:793 via :345-360), which silently disables the
    # documented compensation for every real ISO value. We implement the
    # documented behavior by default: boost sharpness above ISO 800. Setting
    # exif_adjustments.reference_iso_parity = true in the config reproduces
    # the reference's effective (no-op) behavior for bit-parity comparisons;
    # the parity test suite pins it (see tests/test_scoring.py).
    adjusted_sharpness = safe_float(m.get("tech_sharpness"), 5.0)
    if exif.get("iso_sharpness_compensation", True) \
            and not exif.get("reference_iso_parity", False):
        iso = _parse_iso(m.get("iso"))
        if iso and iso > 800:
            adjusted_sharpness = min(10.0, adjusted_sharpness + 0.5 * np.log2(iso / 800))

    # 2. Aperture isolation boost
    effective_isolation = m.get("isolation_bonus", 1.0)
    if effective_isolation is None:
        effective_isolation = 1.0
    if exif.get("aperture_isolation_boost", True):
        f_stop = safe_float(m.get("f_stop"), None)
        if f_stop and f_stop <= 2.8:
            effective_isolation = min(
                3.0, effective_isolation * (1.5 if f_stop <= 2.0 else 1.3))
    isolation_score = min(10.0, (effective_isolation - 1.0) * 5.0)

    # 3. Clipping penalty (silhouettes exempt)
    exposure_settings = config.get_exposure_settings() if config else {}
    is_silhouette = (m.get("is_silhouette", 0)
                     if exposure_settings.get("silhouette_detection", True) else False)
    clipping_penalty = 0.0
    if not is_silhouette:
        shadow = m.get("shadow_clipped", 0) or 0
        highlight = m.get("highlight_clipped", 0) or 0
        if shadow or highlight:
            clipping_penalty = shadow * 0.5 + highlight * 1.0

    dynamic_range_score = min(10.0, safe_float(m.get("histogram_spread"), 0) / 6.0)

    pen = scoring_penalties(m, config)

    category = determine_photo_category(m, config)
    w = config.get_weights(category) if config else {}

    aes = safe_float(m.get("aesthetic"), 5.0)
    exp = safe_float(m.get("exposure_score"), 5.0)
    col = 5.0 if m.get("is_monochrome", 0) else safe_float(m.get("color_score"), 5.0)
    comp_raw = safe_float(m.get("comp_score"), 5.0)
    contrast = safe_float(m.get("contrast_score"), 5.0)
    face_qual = safe_float(m.get("face_quality"), 5.0)
    eye_sharp = safe_float(m.get("eye_sharpness"), 5.0)
    face_sharp = safe_float(m.get("face_sharpness"), 5.0)
    power_point = safe_float(m.get("power_point_score"), 5.0)
    saturation = min(10.0, safe_float(m.get("mean_saturation"), 0.5) * 10.0)
    noise_score = max(0.0, min(10.0, 10.0 - pen["noise_sigma"] * 0.7))

    # Leading-lines blend into composition outside portrait categories
    if category not in ("portrait", "group_portrait") and pen["leading_lines"] > 0:
        comp = min(10.0, comp_raw + pen["leading_lines"] * pen["leading_lines_blend"])
    else:
        comp = comp_raw

    # The 'quality' weight is folded into the aesthetic term: there is no
    # independent quality signal, so its weight shifts the aesthetic value
    # (clamped at 10) rather than multiplying a constant.
    aes_extra = w.get("quality", 0.0)
    w_aes = w.get("aesthetic", 0.0)
    aes_value = aes + aes_extra / max(w_aes, 0.01) if w_aes > 0 else aes

    values = {
        "aesthetic": aes_value,
        "quality": 0.0,
        "face_quality": face_qual,
        "face_sharpness": face_sharp,
        "eye_sharpness": eye_sharp,
        "tech_sharpness": adjusted_sharpness,
        "composition": comp,
        "power_point": power_point,
        "leading_lines": pen["leading_lines"],
        "exposure": exp,
        "color": col,
        "contrast": contrast,
        "dynamic_range": dynamic_range_score,
        "saturation": saturation,
        "noise": noise_score,
        "isolation": isolation_score,
    }

    apply_blink = w.get("_apply_blink_penalty", category in FACE_CATEGORIES)
    skip_clipping = w.get("_skip_clipping_penalty", category == "silhouette")
    noise_tolerance = w.get("noise_tolerance_multiplier", 1.0)
    clipping_multiplier = w.get("_clipping_multiplier", 1.5 if category == "default" else 1.0)
    skip_oversaturation = w.get(
        "_skip_oversaturation_penalty", category in ("night", "astro", "concert"))

    score = 0.0
    for key in METRIC_KEYS:
        weight = w.get(key, 0.0)
        if weight > 0:
            score += max(0.0, min(10.0, values[key])) * weight

    if apply_blink and m.get("is_blink"):
        score *= blink_penalty

    score += w.get("bonus", 0.0)

    if not skip_clipping:
        score -= clipping_penalty * clipping_multiplier
    score -= pen["noise_penalty"] * noise_tolerance
    score -= pen["bimodality_penalty"]
    if not skip_oversaturation:
        score -= pen["oversaturation_penalty"]

    return min(score_max, max(score_min, score)), category
