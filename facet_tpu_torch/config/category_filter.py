"""Declarative category filters.

A category matches a photo when every defined constraint holds:
- numeric ranges over face_ratio / face_count / iso / shutter_speed /
  luminance / focal_length / f_stop (a defined constraint with a missing
  photo value is a non-match — we can't verify it);
- boolean flags has_face / is_monochrome / is_silhouette / is_group_portrait;
- required/excluded tags with "any" or "all" match mode.

Semantics match the reference exactly (config/category_filter.py:55-149).
"""

VALID_NUMERIC_FILTERS = [
    "face_ratio_min", "face_ratio_max",
    "face_count_min", "face_count_max",
    "iso_min", "iso_max",
    "shutter_speed_min", "shutter_speed_max",
    "luminance_min", "luminance_max",
    "focal_length_min", "focal_length_max",
    "f_stop_min", "f_stop_max",
]

VALID_BOOLEAN_FILTERS = ["has_face", "is_monochrome", "is_silhouette", "is_group_portrait"]

VALID_TAG_FILTERS = ["required_tags", "excluded_tags", "tag_match_mode"]

# The 12 weight columns a category may distribute 100% across.
VALID_WEIGHT_COLUMNS = [
    "aesthetic", "face_quality", "eye_sharpness", "tech_sharpness",
    "exposure", "composition", "color", "quality", "contrast",
    "dynamic_range", "isolation", "leading_lines",
]

# photo_data key each numeric filter field reads from
_NUMERIC_SOURCES = {
    "face_ratio": "face_ratio",
    "face_count": "face_count",
    "iso": "iso",
    "shutter_speed": "shutter_speed",
    "luminance": "mean_luminance",
    "focal_length": "focal_length",
    "f_stop": "f_stop",
}


class CategoryFilter:
    """Evaluates whether a photo's metrics match a category's filter rules."""

    def __init__(self, filter_config):
        self.filters = dict(filter_config or {})

    def matches(self, photo_data):
        if not self.filters:
            return True  # empty filter set = catch-all category

        for field, source_key in _NUMERIC_SOURCES.items():
            lo = self.filters.get(f"{field}_min")
            hi = self.filters.get(f"{field}_max")
            if lo is None and hi is None:
                continue
            actual = photo_data.get(source_key)
            if actual is None:
                return False
            if lo is not None and actual < lo:
                return False
            if hi is not None and actual > hi:
                return False

        want_face = self.filters.get("has_face")
        if want_face is not None:
            if bool((photo_data.get("face_count") or 0) > 0) != bool(want_face):
                return False
        for flag in ("is_monochrome", "is_silhouette", "is_group_portrait"):
            want = self.filters.get(flag)
            if want is not None and bool(photo_data.get(flag, 0)) != bool(want):
                return False

        required = self.filters.get("required_tags") or []
        excluded = self.filters.get("excluded_tags") or []
        if required or excluded:
            raw = photo_data.get("tags") or ""
            photo_tags = {t.strip().lower() for t in raw.split(",") if t.strip()}
            if required:
                wanted = [t.lower() for t in required]
                mode = self.filters.get("tag_match_mode", "any")
                hits = [t in photo_tags for t in wanted]
                if mode == "all":
                    if not all(hits):
                        return False
                elif not any(hits):
                    return False
            if excluded and any(t.lower() in photo_tags for t in excluded):
                return False

        return True
