"""Built-in default scoring configuration (v4.0 category-centric).

The config drives category classification (priority-ordered declarative
filters), per-category metric weights (12 columns summing to 100%), scoring
modifiers, the zero-shot tag vocabulary, penalty/threshold constants, the
processing envelope and the model profiles. The reference ships this as a
large JSON file (scoring_config.json); we build it programmatically so the
defaults are readable and testable, and write it to disk on first run.
"""

import json
import os

WEIGHT_KEYS = [
    "aesthetic", "face_quality", "eye_sharpness", "tech_sharpness",
    "exposure", "composition", "color", "quality", "contrast",
    "dynamic_range", "isolation", "leading_lines",
]


def _weights(**kw):
    """Expand shorthand weights into the full *_percent dict (zeros filled).

    Raises if the provided weights don't sum to 100 — defaults must be exact.
    """
    total = sum(kw.values())
    if total != 100:
        raise ValueError(f"weights must sum to 100, got {total}: {kw}")
    unknown = set(kw) - set(WEIGHT_KEYS)
    if unknown:
        raise ValueError(f"unknown weight keys: {unknown}")
    return {f"{key}_percent": kw.get(key, 0) for key in WEIGHT_KEYS}


def _cat(name, priority, filters=None, weights=None, modifiers=None, tags=None):
    return {
        "name": name,
        "priority": priority,
        "filters": filters or {},
        "weights": weights,
        "modifiers": modifiers or {},
        "tags": tags or {},
    }


def _categories():
    """The 30 content categories in priority order (lower = checked first)."""
    return [
        _cat("art", 5,
             filters={"required_tags": ["painting", "statue", "drawing", "cartoon", "anime"],
                      "tag_match_mode": "any"},
             weights=_weights(aesthetic=36, tech_sharpness=4, exposure=8, composition=20,
                              color=12, contrast=8, dynamic_range=4, leading_lines=8),
             modifiers={"bonus": 0.2},
             tags={
                 "painting": ["painting", "oil on canvas", "framed artwork", "fine art painting"],
                 "statue": ["statue", "stone sculpture", "bronze figure", "carved monument"],
                 "drawing": ["drawing", "pencil sketch", "ink illustration", "hand-drawn art"],
                 "cartoon": ["cartoon", "comic panel", "animated drawing"],
                 "anime": ["anime", "manga art", "japanese animation style"],
             }),
        _cat("astro", 10,
             filters={"shutter_speed_min": 10.0, "luminance_max": 0.15},
             weights=_weights(aesthetic=24, tech_sharpness=10, exposure=14, composition=14,
                              color=10, contrast=10, dynamic_range=18),
             modifiers={"noise_tolerance_multiplier": 0.5, "bonus": 0.3,
                        "_skip_clipping_penalty": True, "_skip_oversaturation_penalty": True},
             tags={
                 "stars": ["starry night sky", "field of stars"],
                 "milky way": ["milky way galaxy band"],
                 "aurora": ["aurora borealis", "polar lights in the sky"],
                 "galaxy": ["deep sky galaxy"],
                 "nebula": ["colorful nebula"],
                 "astrophotography": ["long exposure night sky", "astrophotography"],
             }),
        _cat("concert", 15,
             filters={"required_tags": ["concert"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=30, tech_sharpness=6, exposure=10, composition=14,
                              color=12, contrast=14, dynamic_range=8, isolation=6),
             modifiers={"noise_tolerance_multiplier": 0.1, "_skip_oversaturation_penalty": True},
             tags={
                 "concert": ["live concert stage", "musician performing under stage lights",
                             "band playing a show", "crowd at a music festival",
                             "singer with a microphone on stage", "dj set with light show"],
             }),
        _cat("street", 25,
             filters={"required_tags": ["street", "candid"], "tag_match_mode": "any",
                      "has_face": True},
             weights=_weights(aesthetic=30, face_quality=6, tech_sharpness=8, exposure=10,
                              composition=18, color=6, contrast=8, dynamic_range=4,
                              leading_lines=10),
             tags={
                 "street": ["street photography", "people on a city sidewalk",
                            "urban street scene with pedestrians"],
                 "candid": ["candid moment of a stranger", "unposed everyday scene"],
             }),
        _cat("group_portrait", 35,
             filters={"face_ratio_min": 0.05, "has_face": True, "is_group_portrait": True},
             weights=_weights(aesthetic=28, face_quality=24, eye_sharpness=8, tech_sharpness=6,
                              exposure=8, composition=10, color=4, contrast=4,
                              dynamic_range=2, isolation=6),
             modifiers={"bonus": 0.3, "_apply_blink_penalty": True}),
        _cat("silhouette", 42,
             filters={"is_silhouette": True, "has_face": True},
             weights=_weights(aesthetic=30, tech_sharpness=4, exposure=10, composition=24,
                              color=8, contrast=12, dynamic_range=8, leading_lines=4),
             modifiers={"bonus": 0.3, "_skip_clipping_penalty": True,
                        "_skip_oversaturation_penalty": True}),
        _cat("portrait", 45,
             filters={"face_ratio_min": 0.05, "has_face": True, "is_silhouette": False,
                      "is_group_portrait": False, "is_monochrome": False},
             weights=_weights(aesthetic=30, face_quality=20, eye_sharpness=12, tech_sharpness=6,
                              exposure=8, composition=8, color=4, contrast=4,
                              dynamic_range=2, isolation=6),
             modifiers={"bonus": 0.5, "_apply_blink_penalty": True}),
        _cat("portrait_bw", 46,
             filters={"face_ratio_min": 0.05, "has_face": True, "is_monochrome": True,
                      "is_silhouette": False, "is_group_portrait": False},
             weights=_weights(aesthetic=30, face_quality=20, eye_sharpness=12, tech_sharpness=6,
                              exposure=10, composition=8, contrast=8, dynamic_range=2,
                              isolation=4),
             modifiers={"bonus": 0.5, "_apply_blink_penalty": True, "_clipping_multiplier": 1.5}),
        _cat("human_others", 50,
             filters={"has_face": True, "face_ratio_max": 0.05},
             weights=_weights(aesthetic=30, face_quality=6, tech_sharpness=8, exposure=10,
                              composition=16, color=8, contrast=8, dynamic_range=6,
                              isolation=4, leading_lines=4),
             modifiers={"bonus": 0.3}),
        _cat("macro", 55,
             filters={"required_tags": ["macro", "insect", "butterfly", "flower"],
                      "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=16, exposure=8, composition=14,
                              color=10, contrast=8, dynamic_range=4, isolation=12),
             modifiers={"bonus": 0.3},
             tags={
                 "macro": ["extreme close-up macro photo", "macro detail shot"],
                 "insect": ["insect close-up", "bug on a leaf"],
                 "butterfly": ["butterfly on a flower"],
                 "flower": ["flower close-up", "blooming petals macro"],
             }),
        _cat("aerial", 60,
             filters={"required_tags": ["aerial"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=10, exposure=10, composition=20,
                              color=10, contrast=8, dynamic_range=6, leading_lines=8),
             tags={"aerial": ["aerial drone view", "bird's-eye view from above",
                              "top-down landscape from the air"]}),
        _cat("wildlife", 65,
             filters={"required_tags": ["animal"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=14, exposure=8, composition=14,
                              color=8, contrast=8, dynamic_range=4, isolation=16),
             modifiers={"bonus": 0.5},
             tags={"animal": ["wild animal", "bird in flight", "animal portrait in nature",
                              "pet dog", "pet cat", "deer in a forest"]}),
        _cat("food", 70,
             filters={"required_tags": ["food"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=32, tech_sharpness=10, exposure=10, composition=16,
                              color=14, contrast=8, dynamic_range=2, isolation=8),
             tags={"food": ["plated food dish", "food photography", "meal on a table",
                            "dessert close-up", "drink in a glass"]}),
        _cat("sports", 71,
             filters={"required_tags": ["sports", "motion"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=16, exposure=8, composition=16,
                              color=6, contrast=10, dynamic_range=4, isolation=12),
             modifiers={"noise_tolerance_multiplier": 0.5},
             tags={
                 "sports": ["athlete in action", "sports match", "runner mid-stride",
                            "cyclist racing"],
                 "motion": ["frozen fast motion", "action shot with motion blur"],
             }),
        _cat("vehicle", 72,
             filters={"required_tags": ["vehicle"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=30, tech_sharpness=12, exposure=10, composition=16,
                              color=10, contrast=10, dynamic_range=4, leading_lines=8),
             tags={"vehicle": ["car on a road", "classic automobile", "motorcycle",
                               "airplane", "train", "boat on water"]}),
        _cat("travel", 73,
             filters={"required_tags": ["travel"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=30, tech_sharpness=8, exposure=10, composition=18,
                              color=12, contrast=8, dynamic_range=6, leading_lines=8),
             tags={"travel": ["famous landmark", "tourist destination",
                              "historic old town", "temple or cathedral"]}),
        _cat("fashion", 74,
             filters={"required_tags": ["fashion"], "tag_match_mode": "any", "has_face": True},
             weights=_weights(aesthetic=32, face_quality=14, eye_sharpness=8, tech_sharpness=6,
                              exposure=8, composition=12, color=8, contrast=6, isolation=6),
             modifiers={"bonus": 0.2},
             tags={"fashion": ["fashion editorial shoot", "model posing in designer clothes",
                               "runway look", "studio fashion portrait"]}),
        _cat("architecture", 76,
             filters={"required_tags": ["architecture", "building"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=10, exposure=10, composition=22,
                              color=6, contrast=8, dynamic_range=6, leading_lines=10),
             tags={
                 "architecture": ["modern architecture exterior", "architectural detail",
                                  "interior architecture"],
                 "building": ["skyscraper", "historic building facade", "bridge structure"],
             }),
        _cat("urban", 78,
             filters={"required_tags": ["street", "city"], "tag_match_mode": "any",
                      "has_face": False},
             weights=_weights(aesthetic=28, tech_sharpness=8, exposure=10, composition=20,
                              color=8, contrast=10, dynamic_range=6, leading_lines=10),
             tags={
                 "city": ["city skyline", "downtown at dusk", "urban cityscape"],
                 "street": ["empty city street", "alleyway", "crosswalk from above"],
             }),
        _cat("long_exposure", 80,
             filters={"shutter_speed_min": 1.0, "shutter_speed_max": 10.0},
             weights=_weights(aesthetic=28, tech_sharpness=8, exposure=14, composition=16,
                              color=8, contrast=10, dynamic_range=12, leading_lines=4)),
        _cat("cinematic", 82,
             filters={"required_tags": ["cinematic"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=32, tech_sharpness=6, exposure=12, composition=16,
                              color=12, contrast=12, dynamic_range=10),
             modifiers={"bonus": 0.2},
             tags={"cinematic": ["cinematic film still", "moody cinematic lighting",
                                 "anamorphic movie frame look"]}),
        _cat("vintage", 83,
             filters={"required_tags": ["vintage"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=32, tech_sharpness=4, exposure=12, composition=16,
                              color=14, contrast=10, dynamic_range=4, leading_lines=8),
             modifiers={"noise_tolerance_multiplier": 0.3, "bonus": 0.2},
             tags={"vintage": ["vintage film photo", "retro analog look", "faded old photograph"]}),
        _cat("abstract", 84,
             filters={"required_tags": ["texture", "mural", "abstract"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=34, tech_sharpness=8, exposure=8, composition=22,
                              color=12, contrast=10, dynamic_range=2, leading_lines=4),
             tags={
                 "texture": ["abstract texture pattern", "close-up of a surface texture"],
                 "mural": ["wall mural", "street art graffiti"],
                 "abstract": ["abstract shapes and colors", "geometric abstract composition"],
             }),
        _cat("night", 85,
             filters={"luminance_max": 0.15},
             weights=_weights(aesthetic=26, tech_sharpness=8, exposure=14, composition=14,
                              color=10, contrast=12, dynamic_range=12, isolation=4),
             modifiers={"noise_tolerance_multiplier": 0.5, "bonus": 0.2,
                        "_skip_oversaturation_penalty": True},
             tags={
                 "night": ["city at night", "night scene"],
                 "neon": ["neon signs at night"],
                 "moon": ["moon in the night sky"],
                 "fireworks": ["fireworks display"],
                 "light trails": ["car light trails at night"],
             }),
        _cat("minimalist", 86,
             filters={"required_tags": ["minimalist"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=34, tech_sharpness=6, exposure=10, composition=26,
                              color=8, contrast=10, dynamic_range=2, leading_lines=4),
             modifiers={"bonus": 0.2},
             tags={"minimalist": ["minimalist composition with negative space",
                                  "single subject on a plain background"]}),
        _cat("dramatic", 87,
             filters={"required_tags": ["dramatic"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=30, tech_sharpness=6, exposure=12, composition=14,
                              color=8, contrast=14, dynamic_range=12, leading_lines=4),
             modifiers={"bonus": 0.2},
             tags={"dramatic": ["dramatic storm light", "dramatic sky with sun rays",
                                "high-contrast dramatic scene"]}),
        _cat("monochrome", 88,
             filters={"is_monochrome": True},
             weights=_weights(aesthetic=30, tech_sharpness=10, exposure=12, composition=16,
                              contrast=16, dynamic_range=10, leading_lines=6),
             modifiers={"bonus": 0.5, "_clipping_multiplier": 1.5},
             tags={"monochrome": ["black and white photograph"]}),
        _cat("weather", 89,
             filters={"required_tags": ["fog", "rain", "snow", "storm"], "tag_match_mode": "any"},
             weights=_weights(aesthetic=28, tech_sharpness=6, exposure=12, composition=16,
                              color=8, contrast=12, dynamic_range=12, leading_lines=6),
             modifiers={"bonus": 0.3, "noise_tolerance_multiplier": 0.5},
             tags={
                 "fog": ["foggy landscape", "mist over a valley"],
                 "rain": ["rainy day scene", "rain drops on glass"],
                 "snow": ["snow covered landscape", "snowfall"],
                 "storm": ["storm clouds", "lightning strike"],
             }),
        _cat("landscape", 100,
             filters={"required_tags": ["landscape", "mountain", "beach", "forest",
                                        "sunset", "water", "sky", "reflection"],
                      "tag_match_mode": "any"},
             weights=_weights(aesthetic=26, tech_sharpness=10, exposure=12, composition=16,
                              color=10, contrast=8, dynamic_range=10, leading_lines=8),
             modifiers={"bonus": 0.5, "_clipping_multiplier": 1.5},
             tags={
                 "landscape": ["wide landscape vista", "rolling hills panorama"],
                 "mountain": ["mountain range", "alpine peak"],
                 "beach": ["sandy beach coastline", "ocean waves on shore"],
                 "forest": ["forest trees", "woodland path"],
                 "sunset": ["sunset over the horizon", "golden sunrise"],
                 "water": ["lake", "river", "waterfall"],
                 "sky": ["dramatic clouds in the sky"],
                 "reflection": ["mirror reflection on still water"],
             }),
        _cat("default", 999,
             weights=_weights(aesthetic=30, tech_sharpness=10, exposure=12, composition=14,
                              color=8, contrast=8, dynamic_range=6, isolation=4,
                              leading_lines=8)),
    ]


def build_default_config():
    """Assemble the complete default configuration dict."""
    return {
        "scanning": {"skip_hidden_directories": True},
        "categories": _categories(),
        "standalone_tags": {
            "bokeh": ["shallow depth of field with creamy bokeh", "blurred background highlights"],
            "surreal": ["surreal dreamlike scene", "double exposure composite"],
            "flat_lay": ["flat lay arrangement from above"],
            "golden_hour": ["warm golden hour light"],
            "portrait_tag": ["portrait of a person", "close-up headshot"],
            "wedding": ["wedding ceremony", "bride and groom"],
            "product": ["studio product photo on a clean background"],
        },
        "scoring": {"score_min": 0.0, "score_max": 10.0, "score_precision": 2},
        "thresholds": {
            "portrait_face_ratio_percent": 5,
            "blink_penalty_percent": 50,
            "night_luminance_threshold": 0.15,
            "night_iso_threshold": 3200,
            "long_exposure_shutter_threshold": 1.0,
            "astro_shutter_threshold": 10.0,
        },
        "composition": {"power_point_weight": 2.0, "line_weight": 1.0},
        "exif_adjustments": {
            "iso_sharpness_compensation": True,
            "aperture_isolation_boost": True,
        },
        "exposure": {
            "shadow_clip_threshold_percent": 15,
            "highlight_clip_threshold_percent": 10,
            "silhouette_detection": True,
        },
        "penalties": {
            "noise_sigma_threshold": 4.0,
            "noise_max_penalty_points": 1.5,
            "noise_penalty_per_sigma": 0.3,
            "bimodality_threshold": 2.5,
            "bimodality_penalty_points": 0.5,
            "leading_lines_blend_percent": 30,
            "oversaturation_threshold": 0.9,
            "oversaturation_penalty_points": 0.5,
            # vocabulary parity: present in the reference config
            # (scoring_config.json) but consumed by no reference code path
            "oversaturation_pixel_percent": 5,
        },
        "normalization": {
            "method": "percentile",
            "percentile_target": 95,
            "per_category": True,
            "category_min_samples": 50,
        },
        "processing": {
            "mode": "auto",
            # FAST MODE (measured divergence, default off): compute the H-S
            # color-harmony entropy from a stride-4 pixel subsample. Every
            # other metric stays exact; docs/SCORING.md records the measured
            # score-delta distribution. The exact path is the parity-tested
            # default (reference formula: analyzers/technical.py:79-113).
            "fast_color_harmony": False,
            # SPEED TIER (measured divergence, default exact): "fast" trades
            # bounded accuracy for throughput the same way the reference's
            # VRAM profiles trade model sets (models/model_manager.py:630-667)
            # and pyiqa caps inference resolution (pyiqa_scorer.py:131-135):
            # stride-4 color-harmony entropy (implies fast_color_harmony),
            # TOPIQ evaluated at 256px instead of 384px, SCRFD face detection
            # at 448px instead of 640px. docs/SCORING.md documents each
            # divergence and its measured cost; the parity suite pins exact.
            "speed_tier": "exact",
            "device_batch_size": 16,
            "gpu_batch_size": 16,          # reference-compatible alias
            "ram_chunk_size": 100,
            "num_workers": 4,
            "auto_tuning": {
                "enabled": True,
                "monitor_interval_seconds": 5,
                "tuning_interval_images": 50,
                "min_processing_workers": 1,
                "max_processing_workers": 24,
                "min_gpu_batch_size": 2,
                "max_gpu_batch_size": 256,
                "min_ram_chunk_size": 10,
                "max_ram_chunk_size": 500,
                "memory_limit_percent": 85,
                "cpu_target_percent": 80,
                "metrics_print_interval_seconds": 30,
            },
            "thumbnails": {"photo_size": 640, "photo_quality": 80, "face_padding_ratio": 0.3},
        },
        "burst_detection": {
            "similarity_threshold_percent": 88,
            "time_window_minutes": 60,
            "rapid_burst_seconds": 5,
        },
        "duplicate_detection": {"similarity_threshold_percent": 90},
        "models": {
            # Kept key name for CLI/config compatibility; on TPU this selects
            # the ensemble by available HBM per device.
            "vram_profile": "auto",
            "keep_in_ram": "auto",
            # per-model blocks in the reference vocabulary
            # (scoring_config.json models.qwen2_vl / models.ram_plus)
            "qwen2_vl": {"model_path": "Qwen/Qwen2-VL-2B-Instruct",
                         "torch_dtype": "bfloat16", "max_new_tokens": 256},
            "ram_plus": {"model_path":
                         "xinyu1205/recognize-anything-plus-model",
                         "checkpoint": "ram_plus_swin_large_14m.pth"},
            "profiles": {
                "legacy": {
                    "aesthetic_model": "clip-mlp",
                    "composition_model": "rule-based",
                    "tagging_model": "clip",
                    "description": "CLIP ViT-L/14 + MLP aesthetic, rule-based composition",
                },
                "8gb": {
                    "aesthetic_model": "clip-mlp",
                    "composition_model": "samp-net",
                    "tagging_model": "clip",
                    "description": "CLIP+MLP aesthetic, SAMP-Net composition",
                },
                "16gb": {
                    "aesthetic_model": "topiq",
                    "composition_model": "samp-net",
                    "tagging_model": "clip",
                    "description": "TOPIQ aesthetic, SAMP-Net composition, CLIP tagging",
                },
                "24gb": {
                    "aesthetic_model": "topiq",
                    "composition_model": "samp-net",
                    "tagging_model": "qwen2.5-vl-7b",
                    "description": "TOPIQ aesthetic, SAMP-Net composition, VLM tagging",
                },
            },
            "clip": {
                "model_name": "ViT-L-14",
                "pretrained": "laion2b_s32b_b82k",
                "similarity_threshold_percent": 22,
            },
            "samp_net": {
                "model_path": "pretrained_models/samp_net.npz",
                "input_size": 224,
                "patterns": ["none", "center", "rule_of_thirds", "golden_ratio", "triangle",
                             "horizontal", "vertical", "diagonal", "symmetric", "curved",
                             "radial", "vanishing_point", "pattern", "fill_frame"],
            },
            "qwen2_5_vl_7b": {
                "model_path": "Qwen/Qwen2.5-VL-7B-Instruct",
                "dtype": "bfloat16",
                "vlm_batch_size": 2,
            },
            "qwen3_vl_2b": {
                "model_path": "Qwen/Qwen3-VL-2B-Instruct",
                "dtype": "bfloat16",
                "max_new_tokens": 100,
                "vlm_batch_size": 4,
            },
        },
        "quality": {"model": "auto", "prefer_llm": False},
        "analysis": {
            "aesthetic_max_threshold": 9.0,
            "aesthetic_target": 9.5,
            "quality_avg_threshold": 7.5,
            "quality_weight_threshold_percent": 10,
            "correlation_dominant_threshold": 0.5,
            "category_min_samples": 50,
            "category_imbalance_threshold": 0.5,
            "score_clustering_std_threshold": 1.0,
            "top_score_threshold": 8.5,
            "exposure_avg_threshold": 8.0,
        },
        "face_detection": {
            "min_confidence_percent": 70,
            "min_face_size": 30,
            "blink_ear_threshold": 0.21,
            "min_faces_for_group": 4,
        },
        "monochrome_detection": {"saturation_threshold_percent": 10},
        "tagging": {"enabled": True, "max_tags": 5},
        "face_clustering": {
            "enabled": True,
            "min_faces_per_person": 2,
            "min_samples": 2,
            "auto_merge_distance_percent": 15,
            "clustering_algorithm": "best",
            "leaf_size": 40,
            "use_gpu": "auto",
            "merge_threshold": 0.6,
            "chunk_size": 10000,
        },
        "face_processing": {
            "crop_padding": 0.3,
            "use_db_thumbnails": True,
            "face_thumbnail_size": 640,
            "face_thumbnail_quality": 90,
            "extract_workers": 2,
            "extract_batch_size": 16,
            "refill_workers": 4,
            "refill_batch_size": 100,
            "auto_tuning": {
                "enabled": True,
                "memory_limit_percent": 80,
                "min_batch_size": 8,
                "monitor_interval_seconds": 5,
            },
        },
        "viewer": {
            "password": "",
            "edition_password": "",
            "default_category": "default",
            "comparison_mode": {
                "enabled": True,
                "min_comparisons_for_optimization": 50,
                "pair_selection_strategy": "uncertainty",
                "show_current_scores": False,
            },
            "pagination": {"default_page_size": 100, "max_page_size": 500},
            "quality_thresholds": {"good": 6, "great": 7, "excellent": 8, "best": 9},
            "defaults": {
                "hide_blinks": True,
                "hide_bursts": True,
                "hide_duplicates": True,
                "hide_rejected": True,
                "sort": "aggregate",
                "order": "desc",
            },
            "sort_options": {
                "scores": ["aggregate", "top_picks_score", "aesthetic",
                           "quality_score", "topiq_score",
                           "comp_score", "face_quality", "eye_sharpness", "face_sharpness"],
                "technical": ["tech_sharpness", "exposure_score", "color_score",
                              "contrast_score", "dynamic_range_stops", "noise_sigma"],
                "composition": ["power_point_score", "leading_lines_score"],
                "exif": ["date_taken", "iso", "f_stop", "focal_length"],
                "faces": ["face_count", "face_ratio"],
                "user": ["star_rating"],
                "other": ["filename", "category"],
            },
            "features": {
                "stats": True,
                "persons": True,
                "comparison": True,
                "download": True,
                "scan": False,
            },
            # reference viewer vocabulary (api/config.py:85-96): the
            # photo_types block drives the top-picks score/threshold
            # (api/top_picks.py), dropdowns caps the filter-option lists,
            # display/notification_duration_ms are client knobs served
            # through /api/config
            "photo_types": {
                "top_picks_min_score": 7,
                "top_picks_min_face_ratio": 0.2,
                "top_picks_weights": {"aggregate_percent": 20,
                                      "aesthetic_percent": 32,
                                      "composition_percent": 24,
                                      "face_quality_percent": 24},
                "low_light_max_luminance": 0.2,
            },
            # min_photos_for_person defaults to 1 (the reference CODE
            # default, api/db_helpers.py:219) — its shipped config raises
            # it to 10, which stays a per-deployment choice so upgrades
            # don't silently hide small persons from the dropdown
            "dropdowns": {"max_cameras": 50, "max_lenses": 50,
                          "max_persons": 50, "max_tags": 20,
                          "min_photos_for_person": 1},
            "display": {"tags_per_photo": 4, "card_width_px": 168,
                        "image_width_px": 160},
            "face_thumbnails": {"output_size_px": 64, "jpeg_quality": 80,
                                "crop_padding_ratio": 0.2,
                                "min_crop_size_px": 20},
            "notification_duration_ms": 2000,
            "cache_ttl_seconds": 300,
            "path_mapping": {},
        },
        "share_secret": "",
        "performance": {"mmap_size_mb": 256, "cache_size_mb": 64},
    }


def write_default_config(path="scoring_config.json", overwrite=False):
    """Write the default config JSON if it doesn't already exist."""
    if os.path.exists(path) and not overwrite:
        return path
    with open(path, "w") as fh:
        json.dump(build_default_config(), fh, indent=2)
        fh.write("\n")
    return path
