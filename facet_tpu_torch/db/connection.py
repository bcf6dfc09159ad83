"""SQLite connection management.

Pragmas follow the reference contract (db/connection.py:34-51): WAL journal,
5s busy timeout, foreign keys on, NORMAL synchronous, config-driven mmap and
page-cache sizes, in-memory temp store.
"""

import os
import sqlite3
from contextlib import contextmanager

DEFAULT_DB_PATH = "photo_scores_pro.db"

# Performance pragma defaults; overridable via the scoring config's
# `performance` section (mmap_size_mb / cache_size_mb).
_DEFAULT_MMAP_MB = 256
_DEFAULT_CACHE_MB = 64

_perf_settings = {"mmap_size_mb": _DEFAULT_MMAP_MB, "cache_size_mb": _DEFAULT_CACHE_MB}


def configure_performance(mmap_size_mb=None, cache_size_mb=None):
    """Set process-wide pragma sizing (called once at startup from config)."""
    if mmap_size_mb is not None:
        _perf_settings["mmap_size_mb"] = int(mmap_size_mb)
    if cache_size_mb is not None:
        _perf_settings["cache_size_mb"] = int(cache_size_mb)


def resolve_db_path(db_path=None):
    """Resolve the database path: explicit arg > DB_PATH env > default."""
    return db_path or os.environ.get("DB_PATH") or DEFAULT_DB_PATH


def apply_pragmas(conn):
    """Apply the standard pragma set to a fresh connection."""
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA busy_timeout=5000")
    conn.execute("PRAGMA foreign_keys=ON")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute(f"PRAGMA mmap_size={_perf_settings['mmap_size_mb'] * 1024 * 1024}")
    # cache_size in KiB, negative means "KiB" units to SQLite
    conn.execute(f"PRAGMA cache_size=-{_perf_settings['cache_size_mb'] * 1024}")
    conn.execute("PRAGMA temp_store=MEMORY")
    return conn


def connect(db_path=None, row_factory=True):
    """Open a new pragma'd connection."""
    path = resolve_db_path(db_path)
    conn = sqlite3.connect(path)
    if row_factory:
        conn.row_factory = sqlite3.Row
    apply_pragmas(conn)
    return conn


@contextmanager
def get_connection(db_path=None, row_factory=True):
    """Context manager yielding a pragma'd connection; commits on success,
    rolls back on exception, always closes."""
    conn = connect(db_path, row_factory=row_factory)
    try:
        yield conn
        conn.commit()
    except Exception:
        conn.rollback()
        raise
    finally:
        conn.close()
