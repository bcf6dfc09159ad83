"""ScoringConfig: loads, validates, auto-corrects and serves the scoring config.

Behavioral contract (reference: config/scoring_config.py:73-868):
- requires the v4.0 category-centric format (a `categories` array);
- stamps an md5[:12] `version_hash` into every scored photo row;
- weight validation auto-corrects each category (drop invalid keys, add
  missing keys at 0, decimals→percent, clamp negatives, round, normalize to
  exactly 100% with largest-first rounding and last-gets-remainder) and
  WRITES THE CORRECTED CONFIG BACK TO DISK;
- `get_weights()` converts percents to decimals, renormalizes to 1.0 and
  merges modifiers;
- `determine_category()` returns the first matching category in priority
  order;
- hardware profile resolution: `suggest_hardware_profile(memory_gb)` maps
  the card's memory to an ensemble profile; the caller measures the memory
  (`processing/scorer.py:resolve_profile`, from `torch.cuda.mem_get_info`).

The port's copy of facet_tpu/config/scoring_config.py, without its
accelerator probe and `check_vram_profile_compatibility`, which asked jax
for a TPU's memory.
"""

import hashlib
import json
import os

from facet_tpu_torch.config.category_filter import (
    CategoryFilter,
    VALID_BOOLEAN_FILTERS,
    VALID_NUMERIC_FILTERS,
    VALID_TAG_FILTERS,
    VALID_WEIGHT_COLUMNS,
)
from facet_tpu_torch.config.default_config import build_default_config, write_default_config

# Weights whose total is within this % of 100 are left alone so that small,
# targeted recommendation tweaks survive validation.
NORMALIZATION_TOLERANCE = 5


def _deep_merge(base, override):
    out = dict(base)
    for key, val in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = val
    return out


class ScoringConfig:
    def __init__(self, config_path=None, validate=True, create_default=True):
        self.config_path = config_path or "scoring_config.json"
        if create_default and not os.path.exists(self.config_path):
            write_default_config(self.config_path)
        self.config = self._load()
        self.version_hash = self._hash()
        self._category_filters = None  # lazy cache, invalidated on save
        if validate:
            self.validate_weights(verbose=False)

    # ----------------------------------------------------------------- load

    def _load(self):
        if not os.path.exists(self.config_path):
            raise FileNotFoundError(
                f"Config file not found: {self.config_path} (v4.0 format required)"
            )
        try:
            with open(self.config_path) as fh:
                config = json.load(fh)
        except Exception as exc:
            raise ValueError(f"Could not load config {self.config_path}: {exc}")
        if "categories" not in config:
            raise ValueError(
                f"{self.config_path} is not v4.0 format: missing 'categories' array"
            )
        return config

    def _hash(self):
        blob = json.dumps(self.config, sort_keys=True)
        return hashlib.md5(blob.encode()).hexdigest()[:12]

    def save_config(self):
        with open(self.config_path, "w") as fh:
            json.dump(self.config, fh, indent=2)
            fh.write("\n")
        self.version_hash = self._hash()
        self._category_filters = None

    # ----------------------------------------------------- weight validation

    @staticmethod
    def normalize_weights_to_100(weights, skip_within_tolerance=True):
        """Proportionally rescale percent weights to sum to exactly 100.

        Largest weights get plain rounding; the smallest gets the remainder so
        the integer sum is exact. Returns None when no change is needed.
        """
        if not weights:
            return None
        total = sum(weights.values())
        if total == 0 or abs(total - 100) <= 0.01:
            return None
        if skip_within_tolerance and abs(total - 100) <= NORMALIZATION_TOLERANCE:
            return None
        scale = 100.0 / total
        ordered = sorted(weights, key=lambda k: weights[k], reverse=True)
        out, running = {}, 0
        for i, key in enumerate(ordered):
            if i == len(ordered) - 1:
                val = max(0, 100 - running)
            else:
                val = round(weights[key] * scale)
            out[key] = val
            running += val
        return out

    def validate_weights(self, verbose=False):
        """Validate + auto-correct per-category weights; saves if corrected.

        Returns (is_valid, corrected_category_names).
        """
        corrected = []
        for cat in self.config.get("categories", []):
            name = cat.get("name", "unnamed")
            weights = cat.get("weights")
            if not isinstance(weights, dict):
                continue

            percents, invalid = {}, []
            for key, val in weights.items():
                if key.endswith("_percent") and isinstance(val, (int, float)):
                    if key[:-8] in VALID_WEIGHT_COLUMNS:
                        percents[key] = val
                    else:
                        invalid.append(key)
            if not percents:
                continue

            changes = []
            for key in invalid:
                del weights[key]
                changes.append(f"{key}: removed (invalid)")
            for base in VALID_WEIGHT_COLUMNS:
                key = f"{base}_percent"
                if key not in weights:
                    weights[key] = 0
                    percents[key] = 0
                    changes.append(f"{key}: added at 0")

            # decimals → percents (all values ≤ 1 and total ≤ 1)
            if (len(percents) > 1 and all(v <= 1 for v in percents.values())
                    and sum(percents.values()) <= 1.01):
                for key, val in percents.items():
                    new = round(val * 100)
                    if new != val:
                        weights[key] = percents[key] = new
                        changes.append(f"{key}: {val} -> {new} (decimal)")

            for key, val in list(percents.items()):
                if val < 0:
                    weights[key] = percents[key] = 0
                    changes.append(f"{key}: {val} -> 0 (negative)")
            for key, val in list(percents.items()):
                if isinstance(val, float) and val != int(val):
                    new = round(val)
                    weights[key] = percents[key] = new
                    changes.append(f"{key}: {val} -> {new} (rounded)")

            renorm = self.normalize_weights_to_100(percents)
            if renorm:
                for key, new in renorm.items():
                    if new != percents[key]:
                        changes.append(f"{key}: {percents[key]} -> {new}")
                    weights[key] = new

            if changes:
                corrected.append(name)
                if verbose:
                    print(f"Corrected '{name}' weights:")
                    for c in changes:
                        print(f"  {c}")

        if corrected:
            self.save_config()
            if verbose:
                print(f"Saved corrected config to {self.config_path}")
        return (not corrected), corrected

    # ----------------------------------------------------------- weights API

    def get_weights(self, category):
        """Decimal weights for a category, normalized to sum 1.0, merged with
        the category's modifiers (bonus, _apply_blink_penalty, ...)."""
        for cat in self.config.get("categories", []):
            if cat.get("name") != category:
                continue
            out, weight_keys = {}, []
            for key, val in (cat.get("weights") or {}).items():
                if key.endswith("_percent"):
                    base = key[:-8]
                    out[base] = val / 100
                    weight_keys.append(base)
                else:
                    out[key] = val
            if weight_keys:
                total = sum(out[k] for k in weight_keys)
                if total > 0 and abs(total - 1.0) > 0.001:
                    for k in weight_keys:
                        out[k] /= total
            out.update(cat.get("modifiers") or {})
            return out
        return {}

    # -------------------------------------------------------------- getters

    def _section(self, name, defaults):
        return _deep_merge(defaults, self.config.get(name, {}))

    def get_scoring_limits(self):
        s = self.config.get("scoring", {})
        return {
            "score_min": s.get("score_min", 0.0),
            "score_max": s.get("score_max", 10.0),
            "score_precision": s.get("score_precision", 2),
        }

    def get_threshold(self, name):
        return self.config.get("thresholds", {}).get(name, 0)

    def get_thresholds(self):
        return self.config.get("thresholds", {})

    def get_composition_weights(self):
        return self.config.get("composition", {})

    def get_normalization_settings(self):
        return self._section("normalization", {
            "method": "percentile", "percentile_target": 95,
            "per_category": True, "category_min_samples": 50,
        })

    def get_processing_settings(self):
        defaults = build_default_config()["processing"]
        return self._section("processing", defaults)

    def speed_tier(self):
        """processing.speed_tier: "exact" (default) or "fast".

        Unknown values fall back to exact — the conservative tier — so a
        typo never silently trades accuracy. "fast" implies
        fast_color_harmony plus the member eval-size trades documented in
        docs/SCORING.md.
        """
        tier = str(self.get_processing_settings().get(
            "speed_tier", "exact")).lower()
        return tier if tier in ("exact", "fast") else "exact"

    def get_scanning_settings(self):
        return self._section("scanning", {"skip_hidden_directories": True})

    def get_exif_adjustments(self):
        return self._section("exif_adjustments", {
            "iso_sharpness_compensation": True, "aperture_isolation_boost": True,
        })

    def get_exposure_settings(self):
        return self._section("exposure", {
            "shadow_clip_threshold_percent": 15,
            "highlight_clip_threshold_percent": 10,
            "silhouette_detection": True,
        })

    def get_penalty_settings(self):
        return self._section("penalties", {
            "noise_sigma_threshold": 4.0,
            "noise_max_penalty_points": 1.5,
            "noise_penalty_per_sigma": 0.3,
            "bimodality_threshold": 2.5,
            "bimodality_penalty_points": 0.5,
            "leading_lines_blend_percent": 30,
            "oversaturation_threshold": 0.9,
            "oversaturation_penalty_points": 0.5,
        })

    def get_analysis_settings(self):
        defaults = build_default_config()["analysis"]
        return self._section("analysis", defaults)

    def get_face_detection_settings(self):
        return self._section("face_detection", {
            "min_confidence_percent": 70,
            "min_face_size": 30,
            "blink_ear_threshold": 0.21,
            "min_faces_for_group": 4,
        })

    def get_monochrome_settings(self):
        return self._section("monochrome_detection", {"saturation_threshold_percent": 10})

    def get_tagging_settings(self):
        return self._section("tagging", {"enabled": True, "max_tags": 5})

    def get_clip_settings(self):
        models = self.get_model_config()
        return _deep_merge(
            {"model_name": "ViT-L-14", "pretrained": "laion2b_s32b_b82k",
             "similarity_threshold_percent": 22},
            models.get("clip", {}),
        )

    def get_burst_detection_settings(self):
        return self._section("burst_detection", {
            "similarity_threshold_percent": 88,
            "time_window_minutes": 60,
            "rapid_burst_seconds": 5,
        })

    def get_duplicate_detection_settings(self):
        return self._section("duplicate_detection", {"similarity_threshold_percent": 90})

    def get_face_clustering_settings(self):
        defaults = build_default_config()["face_clustering"]
        return self._section("face_clustering", defaults)

    def get_face_processing_settings(self):
        defaults = build_default_config()["face_processing"]
        return self._section("face_processing", defaults)

    def get_comparison_mode_settings(self):
        defaults = {
            "enabled": False,
            "min_comparisons_for_optimization": 50,
            "pair_selection_strategy": "uncertainty",
            "show_current_scores": False,
        }
        return _deep_merge(defaults, self.config.get("viewer", {}).get("comparison_mode", {}))

    def get_viewer_settings(self):
        defaults = build_default_config()["viewer"]
        return self._section("viewer", defaults)

    def get_performance_settings(self):
        return self._section("performance", {"mmap_size_mb": 256, "cache_size_mb": 64})

    # ------------------------------------------------------- model profiles

    def get_model_config(self):
        defaults = build_default_config()["models"]
        return _deep_merge(defaults, self.config.get("models", {}))

    def get_samp_net_config(self):
        models = self.get_model_config()
        return _deep_merge(build_default_config()["models"]["samp_net"],
                           models.get("samp_net", {}))

    def get_model_for_task(self, task):
        """Model name for 'aesthetic' | 'composition' | 'tagging' per profile."""
        models = self.get_model_config()
        profile_name = models.get("vram_profile", "legacy")
        profiles = models.get("profiles", {})
        profile = profiles.get(profile_name) or profiles.get("legacy", {})
        return profile.get(f"{task}_model", "rule-based")

    def is_using_samp_net(self):
        return self.get_model_for_task("composition") == "samp-net"

    @staticmethod
    def suggest_hardware_profile(memory_gb=None):
        """Map accelerator memory to an ensemble profile.

        Returns (profile_name, memory_gb_or_None, message). Thresholds follow
        the reference's VRAM tiers (models/model_manager.py:630-648); None
        (no card) selects the legacy profile.
        """
        if memory_gb is None:
            return "legacy", None, "No accelerator detected - legacy (CPU) profile"
        if memory_gb >= 20:
            profile = "24gb"
        elif memory_gb >= 14:
            profile = "16gb"
        elif memory_gb >= 6:
            profile = "8gb"
        else:
            profile = "legacy"
        return profile, memory_gb, (
            f"Detected {memory_gb:.1f}GB accelerator memory - profile: {profile}"
        )

    # Reference-compatible alias
    suggest_vram_profile = suggest_hardware_profile

    # -------------------------------------------------------------- category

    def get_categories(self):
        cats = self.config.get("categories", [])
        return sorted(cats, key=lambda c: c.get("priority", 100))

    def get_all_category_names(self):
        return [c["name"] for c in self.get_categories()]

    def get_category_config(self, name):
        for cat in self.config.get("categories", []):
            if cat.get("name") == name:
                return cat
        return {}

    def get_category_tags(self, name):
        tags = self.get_category_config(name).get("tags", {})
        return list(tags.keys()) if isinstance(tags, dict) else []

    def get_art_tags(self):
        return set(self.get_category_tags("art"))

    def get_tag_vocabulary(self):
        """{tag: [synonym prompts]} merged from all categories + standalone."""
        vocab = {}
        for cat in self.config.get("categories", []):
            tags = cat.get("tags", {})
            if isinstance(tags, dict):
                vocab.update(tags)
        standalone = self.config.get("standalone_tags", {})
        if isinstance(standalone, dict):
            vocab.update(standalone)
        return vocab

    def determine_category(self, photo_data):
        """First matching category in priority order (cached filters)."""
        if self._category_filters is None:
            self._category_filters = [
                (cat["name"], CategoryFilter(cat.get("filters", {})))
                for cat in self.get_categories()
            ]
        for name, filt in self._category_filters:
            if filt.matches(photo_data):
                return name
        return self.config.get("viewer", {}).get("default_category", "default")

    def validate_categories(self, verbose=False):
        """Structural validation: weights ≈ 100, unique priorities, known filters."""
        issues, seen_priority = [], {}
        valid_filters = set(VALID_NUMERIC_FILTERS + VALID_BOOLEAN_FILTERS + VALID_TAG_FILTERS)
        for cat in self.get_categories():
            name = cat.get("name", "unnamed")
            percents = {k: v for k, v in (cat.get("weights") or {}).items()
                        if k.endswith("_percent")}
            if percents:
                total = sum(percents.values())
                if abs(total - 100) > 1:
                    issues.append(f"{name}: weights sum to {total}%, expected 100%")
            priority = cat.get("priority")
            if priority is None:
                issues.append(f"{name}: missing priority")
            elif priority in seen_priority:
                issues.append(f"duplicate priority {priority}: {name}, {seen_priority[priority]}")
            else:
                seen_priority[priority] = name
            for key in cat.get("filters", {}):
                if key not in valid_filters:
                    issues.append(f"{name}: unknown filter '{key}'")
            mode = cat.get("filters", {}).get("tag_match_mode")
            if mode not in (None, "any", "all"):
                issues.append(f"{name}: invalid tag_match_mode '{mode}'")
        if verbose:
            for issue in issues:
                print(f"Validation issue: {issue}")
        return (not issues), issues
