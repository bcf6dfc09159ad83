"""Burst detection: group visually-similar time-adjacent photos, flag the best.

``process_bursts`` is carried over from ``facet_tpu/utils/burst.py``
unchanged: that module imports ``hamming_distance`` from the JAX pHash
module, so the port keeps its own copy on the port's ``ops/phash.py``.

Semantics per the reference (processing/scorer.py:1880-1986):
- photos sorted by date_taken; a photo joins the current burst if it is
  within the rapid window of any member (relaxed 2x phash threshold, and the
  two photos must share an identified person when both have any), or within
  the slow time window at the strict phash threshold;
- the highest-aggregate member of each burst gets is_burst_lead=1;
- photos without a phash are standalone (is_burst_lead=1).
"""

from datetime import datetime

from facet_tpu_torch.db.connection import get_connection
from facet_tpu_torch.ops.phash import hamming_distance


def _parse_date(date_str):
    if not date_str:
        return None
    for fmt in ("%Y:%m:%d %H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S"):
        try:
            return datetime.strptime(str(date_str)[:19], fmt)
        except (ValueError, TypeError):
            continue
    return None


def process_bursts(db_path, config):
    """Run burst grouping over the whole database. Returns burst-lead count."""
    settings = config.get_burst_detection_settings()
    similarity = settings.get("similarity_threshold_percent", 88)
    window_minutes = settings.get("time_window_minutes", 60)
    rapid_seconds = settings.get("rapid_burst_seconds", 5)
    max_distance = int(64 * (1 - similarity / 100))

    with get_connection(db_path) as conn:
        photos = [dict(r) for r in conn.execute(
            "SELECT path, date_taken, aggregate, phash FROM photos"
            " WHERE phash IS NOT NULL ORDER BY date_taken")]
        # parse each date ONCE (joins_burst compares every member pair —
        # per-comparison strptime dominated large-burst runtime) and sort
        # chronologically by the PARSED date: the reference's lexicographic
        # ORDER BY (scorer.py:1898) mis-orders mixed EXIF/ISO date formats
        # ('-' < ':'), splitting bursts; identical order for single-format
        # libraries, which the parity suite pins.
        for p in photos:
            p["_date"] = _parse_date(p["date_taken"])
        epoch = datetime(1970, 1, 1)
        photos.sort(key=lambda p: (p["_date"] or epoch,
                                   p["date_taken"] or "", p["path"]))

        # photo -> set of identified persons (for rapid-burst consistency)
        persons = {}
        if conn.execute("SELECT 1 FROM faces LIMIT 1").fetchone():
            for path, pid in conn.execute(
                "SELECT photo_path, person_id FROM faces WHERE person_id IS NOT NULL"
            ):
                persons.setdefault(path, set()).add(pid)

        conn.execute("UPDATE photos SET is_burst_lead = 0 WHERE phash IS NOT NULL")
        conn.execute("UPDATE photos SET is_burst_lead = 1 WHERE phash IS NULL")
        if not photos:
            return 0

        def shares_person(a, b):
            pa, pb = persons.get(a, set()), persons.get(b, set())
            if not pa or not pb:
                return True
            return bool(pa & pb)

        def joins_burst(photo, burst):
            pdate = photo["_date"]
            if pdate is None:
                return False
            for member in burst:
                mdate = member["_date"]
                if mdate is None:
                    continue
                dt = abs((pdate - mdate).total_seconds())
                if dt <= rapid_seconds and shares_person(photo["path"], member["path"]):
                    if hamming_distance(photo["phash"], member["phash"]) <= max_distance * 2:
                        return True
                if dt <= window_minutes * 60:
                    if hamming_distance(photo["phash"], member["phash"]) <= max_distance:
                        return True
            return False

        leads = 0

        def finalize(burst):
            nonlocal leads
            winner = max(burst, key=lambda r: r["aggregate"] or 0)
            conn.execute("UPDATE photos SET is_burst_lead = 1 WHERE path = ?",
                         (winner["path"],))
            leads += 1

        burst = [photos[0]]
        for photo in photos[1:]:
            if joins_burst(photo, burst):
                burst.append(photo)
            else:
                finalize(burst)
                burst = [photo]
        finalize(burst)
        return leads
