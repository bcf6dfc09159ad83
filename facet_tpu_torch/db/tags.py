"""photo_tags lookup table management.

The photos.tags column holds a comma-separated string (display format); the
photo_tags table holds one row per (photo, tag) for fast exact-match filtering
(reference: db/tags.py:15). This module keeps the two in sync.
"""

from facet_tpu_torch.db.connection import get_connection


def split_tags(tags_str):
    """Parse a comma-separated tag string into a clean lowercase list."""
    if not tags_str:
        return []
    return [t.strip().lower() for t in tags_str.split(",") if t.strip()]


def sync_photo_tags(conn, photo_path, tags_str):
    """Replace the lookup rows for one photo from its tags string."""
    conn.execute("DELETE FROM photo_tags WHERE photo_path = ?", (photo_path,))
    rows = [(photo_path, t) for t in dict.fromkeys(split_tags(tags_str))]
    if rows:
        conn.executemany(
            "INSERT OR IGNORE INTO photo_tags (photo_path, tag) VALUES (?, ?)", rows
        )


def migrate_tags_to_lookup(db_path=None, verbose=True):
    """Backfill photo_tags from the photos.tags strings (idempotent)."""
    n = 0
    with get_connection(db_path) as conn:
        for path, tags_str in conn.execute(
            "SELECT path, tags FROM photos WHERE tags IS NOT NULL AND tags != ''"
        ).fetchall():
            sync_photo_tags(conn, path, tags_str)
            n += 1
    if verbose:
        print(f"migrated tags for {n} photos into photo_tags")
    return n


def is_photo_tags_populated(conn):
    """True when the lookup table has rows (API uses it instead of LIKE)."""
    try:
        return conn.execute("SELECT 1 FROM photo_tags LIMIT 1").fetchone() is not None
    except Exception:
        return False


def all_tags(db_path=None):
    """Distinct tags with usage counts, most used first."""
    with get_connection(db_path) as conn:
        return [
            (r[0], r[1])
            for r in conn.execute(
                "SELECT tag, COUNT(*) AS cnt FROM photo_tags GROUP BY tag ORDER BY cnt DESC"
            )
        ]
