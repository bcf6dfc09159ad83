"""Database schema: the persistence contract.

Column names, types and constraints match the reference schema exactly
(db/schema.py:14-277) so that existing viewers, validators and exports work
unchanged against databases produced by this engine. The *implementation* is
ours: a declarative table registry with idempotent creation and automatic
add-missing-column migration.
"""

import sqlite3

from facet_tpu_torch.db.connection import apply_pragmas, resolve_db_path

# ---------------------------------------------------------------------------
# Table registry. Each entry: {"columns": [(name, ddl)], "constraints": [...],
# "indexes": [(index_name, column_expr)]}
# ---------------------------------------------------------------------------

TABLES = {}

PHOTO_COLUMNS = [
    # identity + EXIF metadata
    ("path", "TEXT PRIMARY KEY"),
    ("filename", "TEXT"),
    ("date_taken", "TEXT"),
    ("camera_model", "TEXT"),
    ("lens_model", "TEXT"),
    ("iso", "INTEGER"),
    ("f_stop", "REAL"),
    ("shutter_speed", "TEXT"),
    ("focal_length", "REAL"),
    ("focal_length_35mm", "REAL"),
    ("image_width", "INTEGER"),
    ("image_height", "INTEGER"),
    # model + metric scores (0-10 unless noted)
    ("aesthetic", "REAL"),
    ("face_count", "INTEGER DEFAULT 0 CHECK (face_count >= 0)"),
    ("face_quality", "REAL"),
    ("eye_sharpness", "REAL"),
    ("face_sharpness", "REAL"),
    ("face_ratio", "REAL CHECK (face_ratio IS NULL OR (face_ratio >= 0 AND face_ratio <= 1))"),
    ("tech_sharpness", "REAL"),
    ("color_score", "REAL"),
    ("exposure_score", "REAL"),
    ("comp_score", "REAL"),
    ("isolation_bonus", "REAL"),
    ("aggregate", "REAL CHECK (aggregate IS NULL OR (aggregate >= 0 AND aggregate <= 10))"),
    # boolean flags
    ("is_blink", "INTEGER CHECK (is_blink IS NULL OR is_blink IN (0, 1))"),
    ("is_burst_lead", "INTEGER DEFAULT 0 CHECK (is_burst_lead IN (0, 1))"),
    ("is_monochrome", "INTEGER DEFAULT 0 CHECK (is_monochrome IN (0, 1))"),
    ("is_silhouette", "INTEGER"),
    ("is_group_portrait", "INTEGER"),
    # duplicate detection
    ("duplicate_group_id", "INTEGER"),
    ("is_duplicate_lead", "INTEGER DEFAULT 0 CHECK (is_duplicate_lead IN (0, 1))"),
    # raw data kept for rescoring without image access
    ("clip_embedding", "BLOB"),           # 768 float32
    ("raw_sharpness_variance", "REAL"),
    ("histogram_data", "BLOB"),           # 256 float32, normalized gray histogram
    ("histogram_spread", "REAL"),
    ("mean_luminance", "REAL"),
    ("histogram_bimodality", "REAL"),
    ("power_point_score", "REAL"),
    ("raw_color_entropy", "REAL"),
    ("raw_eye_sharpness", "REAL"),
    # additional technical metrics
    ("shadow_clipped", "INTEGER"),
    ("highlight_clipped", "INTEGER"),
    ("dynamic_range_stops", "REAL"),
    ("noise_sigma", "REAL"),
    ("contrast_score", "REAL"),
    ("mean_saturation", "REAL"),
    ("leading_lines_score", "REAL"),
    ("face_confidence", "REAL"),
    # derived outputs
    ("thumbnail", "BLOB"),                # 640px JPEG
    ("phash", "TEXT"),                    # 64-bit perceptual hash, hex
    ("config_version", "TEXT"),           # md5[:12] of the scoring config
    ("tags", "TEXT"),                     # comma-separated
    ("quality_score", "REAL"),
    ("topiq_score", "REAL"),
    ("composition_explanation", "TEXT"),
    ("scoring_model", "TEXT"),
    ("composition_pattern", "TEXT"),
    ("category", "TEXT"),
    # user state
    ("star_rating", "INTEGER DEFAULT 0 CHECK (star_rating >= 0 AND star_rating <= 5)"),
    ("is_favorite", "INTEGER DEFAULT 0 CHECK (is_favorite IN (0, 1))"),
    ("is_rejected", "INTEGER DEFAULT 0 CHECK (is_rejected IN (0, 1))"),
]

TABLES["photos"] = {
    "columns": PHOTO_COLUMNS,
    "constraints": [],
    "indexes": [
        ("idx_date_taken", "date_taken"),
        ("idx_aggregate", "aggregate DESC"),
        ("idx_camera_model", "camera_model"),
        ("idx_lens_model", "lens_model"),
        ("idx_face_count", "face_count"),
        ("idx_face_ratio", "face_ratio"),
        ("idx_is_monochrome", "is_monochrome"),
        ("idx_is_burst_lead", "is_burst_lead"),
        ("idx_tags", "tags"),
        ("idx_aggregate_date", "aggregate DESC, date_taken DESC"),
        ("idx_burst_aggregate", "is_burst_lead, aggregate DESC"),
        ("idx_face_detection", "face_count, face_ratio"),
        ("idx_filename", "filename"),
        ("idx_category", "category"),
        ("idx_category_aggregate", "category, aggregate DESC"),
        ("idx_aesthetic_aggregate", "aesthetic DESC, aggregate DESC"),
        ("idx_face_quality_sort", "face_quality DESC, eye_sharpness DESC"),
        ("idx_tech_sharpness_sort", "tech_sharpness DESC, aesthetic DESC"),
        ("idx_date_taken_desc", "date_taken DESC"),
        ("idx_blink_burst", "is_blink, is_burst_lead"),
        ("idx_composition_pattern", "composition_pattern"),
        ("idx_camera_lens", "camera_model, lens_model"),
        ("idx_duplicate_group", "duplicate_group_id"),
        ("idx_duplicate_lead", "is_duplicate_lead"),
        ("idx_star_rating", "star_rating"),
        ("idx_is_favorite", "is_favorite"),
        ("idx_is_rejected", "is_rejected"),
    ],
}

TABLES["faces"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("photo_path", "TEXT NOT NULL REFERENCES photos(path) ON DELETE CASCADE"),
        ("face_index", "INTEGER NOT NULL"),
        ("embedding", "BLOB NOT NULL"),   # 512 float32 ArcFace
        ("bbox_x1", "INTEGER"),
        ("bbox_y1", "INTEGER"),
        ("bbox_x2", "INTEGER"),
        ("bbox_y2", "INTEGER"),
        ("confidence", "REAL"),
        ("person_id", "INTEGER"),
        ("face_thumbnail", "BLOB"),
        ("landmark_2d_106", "BLOB"),      # 106x2 float32 = 848 bytes
    ],
    "constraints": ["UNIQUE(photo_path, face_index)"],
    "indexes": [
        ("idx_faces_photo", "photo_path"),
        ("idx_faces_person", "person_id"),
        ("idx_faces_person_photo", "person_id, photo_path"),
    ],
}

TABLES["persons"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("name", "TEXT"),
        ("representative_face_id", "INTEGER"),
        ("face_count", "INTEGER DEFAULT 0"),
        ("centroid", "BLOB"),
        ("auto_clustered", "INTEGER DEFAULT 1"),
        ("face_thumbnail", "BLOB"),
    ],
    "constraints": [],
    "indexes": [],
}

TABLES["photo_tags"] = {
    "columns": [
        ("photo_path", "TEXT NOT NULL REFERENCES photos(path) ON DELETE CASCADE"),
        ("tag", "TEXT NOT NULL"),
    ],
    "constraints": ["PRIMARY KEY (photo_path, tag)"],
    "indexes": [
        ("idx_photo_tags_tag", "tag"),
        ("idx_photo_tags_path", "photo_path"),
    ],
}

TABLES["comparisons"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("photo_a_path", "TEXT NOT NULL REFERENCES photos(path) ON DELETE CASCADE"),
        ("photo_b_path", "TEXT NOT NULL REFERENCES photos(path) ON DELETE CASCADE"),
        ("winner", "TEXT NOT NULL CHECK (winner IN ('a', 'b', 'tie', 'skip'))"),
        ("category", "TEXT"),
        ("timestamp", "TEXT DEFAULT (datetime('now'))"),
        ("session_id", "TEXT"),
        ("user_id", "TEXT"),
    ],
    "constraints": ["UNIQUE(photo_a_path, photo_b_path)"],
    "indexes": [
        ("idx_comparisons_photo_a", "photo_a_path"),
        ("idx_comparisons_photo_b", "photo_b_path"),
        ("idx_comparisons_timestamp", "timestamp DESC"),
        ("idx_comparisons_category", "category"),
    ],
}

TABLES["learned_scores"] = {
    "columns": [
        ("photo_path", "TEXT PRIMARY KEY REFERENCES photos(path) ON DELETE CASCADE"),
        ("learned_score", "REAL NOT NULL"),
        ("comparison_count", "INTEGER DEFAULT 0"),
        ("category", "TEXT"),
        ("updated_at", "TEXT DEFAULT (datetime('now'))"),
        ("user_id", "TEXT"),
    ],
    "constraints": [],
    "indexes": [
        ("idx_learned_scores_score", "learned_score DESC"),
        ("idx_learned_scores_category", "category"),
    ],
}

TABLES["weight_optimization_runs"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("timestamp", "TEXT DEFAULT (datetime('now'))"),
        ("category", "TEXT"),
        ("comparisons_used", "INTEGER"),
        ("old_weights", "TEXT"),
        ("new_weights", "TEXT"),
        ("mse_before", "REAL"),
        ("mse_after", "REAL"),
    ],
    "constraints": [],
    "indexes": [
        ("idx_optimization_timestamp", "timestamp DESC"),
        ("idx_optimization_category", "category"),
    ],
}

TABLES["stats_cache"] = {
    "columns": [
        ("key", "TEXT PRIMARY KEY"),
        ("value", "TEXT"),
        ("updated_at", "REAL"),
    ],
    "constraints": [],
    "indexes": [],
}

TABLES["weight_config_snapshots"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("timestamp", "TEXT DEFAULT (datetime('now'))"),
        ("category", "TEXT"),
        ("weights", "TEXT NOT NULL"),
        ("description", "TEXT"),
        ("accuracy_before", "REAL"),
        ("accuracy_after", "REAL"),
        ("comparisons_used", "INTEGER"),
        ("created_by", "TEXT"),
    ],
    "constraints": [],
    "indexes": [
        ("idx_snapshots_timestamp", "timestamp DESC"),
        ("idx_snapshots_category", "category"),
    ],
}

TABLES["recommendation_history"] = {
    "columns": [
        ("id", "INTEGER PRIMARY KEY AUTOINCREMENT"),
        ("run_timestamp", "TEXT DEFAULT (datetime('now'))"),
        ("config_version_hash", "TEXT"),
        ("issue_type", "TEXT NOT NULL"),
        ("target_category", "TEXT"),
        ("target_key", "TEXT"),
        ("old_value", "REAL"),
        ("proposed_value", "REAL"),
        ("was_applied", "INTEGER DEFAULT 0"),
    ],
    "constraints": [],
    "indexes": [
        ("idx_rec_history_timestamp", "run_timestamp DESC"),
        ("idx_rec_history_target", "target_category, target_key"),
    ],
}

TABLES["user_preferences"] = {
    "columns": [
        ("user_id", "TEXT NOT NULL"),
        ("photo_path", "TEXT NOT NULL REFERENCES photos(path) ON DELETE CASCADE"),
        ("star_rating", "INTEGER DEFAULT 0 CHECK (star_rating >= 0 AND star_rating <= 5)"),
        ("is_favorite", "INTEGER DEFAULT 0 CHECK (is_favorite IN (0, 1))"),
        ("is_rejected", "INTEGER DEFAULT 0 CHECK (is_rejected IN (0, 1))"),
    ],
    "constraints": ["PRIMARY KEY (user_id, photo_path)"],
    "indexes": [
        ("idx_user_prefs_user", "user_id"),
        ("idx_user_prefs_path", "photo_path"),
        ("idx_user_prefs_fav", "user_id, is_favorite"),
        ("idx_user_prefs_rating", "user_id, star_rating"),
    ],
}


def _create_sql(name, spec):
    parts = [f"{col} {ddl}" for col, ddl in spec["columns"]]
    parts += spec.get("constraints", [])
    body = ",\n    ".join(parts)
    return f"CREATE TABLE IF NOT EXISTS {name} (\n    {body}\n)"


def _migrate_columns(conn, name, spec):
    """Add columns that exist in the registry but not in the live table."""
    have = {row[1] for row in conn.execute(f"PRAGMA table_info({name})")}
    for col, ddl in spec["columns"]:
        if col in have:
            continue
        # ALTER TABLE can't carry constraints; keep the bare affinity only.
        affinity = ddl.split()[0] if ddl else "TEXT"
        try:
            conn.execute(f"ALTER TABLE {name} ADD COLUMN {col} {affinity}")
        except sqlite3.OperationalError as exc:
            if "duplicate column" not in str(exc).lower():
                raise


def init_database(db_path=None):
    """Create (or migrate) the full schema. Idempotent and safe on live DBs."""
    path = resolve_db_path(db_path)
    with sqlite3.connect(path) as conn:
        apply_pragmas(conn)
        for name, spec in TABLES.items():
            conn.execute(_create_sql(name, spec))
            _migrate_columns(conn, name, spec)
        for name, spec in TABLES.items():
            for idx_name, expr in spec.get("indexes", []):
                conn.execute(f"CREATE INDEX IF NOT EXISTS {idx_name} ON {name}({expr})")
        conn.commit()
    return path


def table_columns(name):
    """Registry column names for a table (ordering matters for inserts)."""
    return [col for col, _ in TABLES[name]["columns"]]
