"""Thumbnail generation (640px q80 JPEG by default; reference scorer.py:1611)."""

import io

from PIL import Image


def make_thumbnail(pil_img, size=640, quality=80):
    """PIL image -> JPEG bytes with the long edge capped at `size`."""
    img = pil_img.copy()
    img.thumbnail((size, size))
    buf = io.BytesIO()
    img.convert("RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def thumbnail_from_array(rgb_array, size=640, quality=80):
    return make_thumbnail(Image.fromarray(rgb_array), size, quality)


def decode_thumbnail(blob):
    """Stored JPEG blob -> RGB numpy array, or None."""
    if not blob:
        return None
    import numpy as np

    try:
        return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"), dtype=np.uint8)
    except Exception:
        return None


_ORIENTATION_TAG = 274

# EXIF orientation -> PIL transpose op undoing it
_ORIENTATION_OPS = {
    2: Image.Transpose.FLIP_LEFT_RIGHT,
    3: Image.Transpose.ROTATE_180,
    4: Image.Transpose.FLIP_TOP_BOTTOM,
    5: Image.Transpose.TRANSPOSE,
    6: Image.Transpose.ROTATE_270,
    7: Image.Transpose.TRANSVERSE,
    8: Image.Transpose.ROTATE_90,
}


def read_exif_orientation(path):
    """EXIF orientation tag from the file header (no full decode), or None."""
    try:
        with Image.open(path) as img:
            return img.getexif().get(_ORIENTATION_TAG)
    except Exception:
        return None


def fix_thumbnail_rotation(db_path, quality=80, verbose=True):
    """Rotate stored thumbnails whose source files carry an EXIF orientation
    (reference: processing/scorer.py fix_thumbnail_rotation — headers only,
    originals are never fully re-decoded). Returns (updated, skipped)."""
    import os

    from facet_tpu_torch.db.connection import get_connection

    updated = skipped = 0
    with get_connection(db_path) as conn:
        rows = conn.execute("SELECT path, thumbnail FROM photos"
                            " WHERE thumbnail IS NOT NULL").fetchall()
        for path, blob in rows:
            if not blob or not os.path.exists(path):
                skipped += 1
                continue
            orientation = read_exif_orientation(path)
            op = _ORIENTATION_OPS.get(orientation)
            if op is None:
                skipped += 1
                continue
            try:
                img = Image.open(io.BytesIO(blob)).transpose(op)
                buf = io.BytesIO()
                img.convert("RGB").save(buf, "JPEG", quality=quality)
                conn.execute("UPDATE photos SET thumbnail = ? WHERE path = ?",
                             (buf.getvalue(), path))
                updated += 1
            except Exception:
                skipped += 1
    if verbose:
        print(f"thumbnail rotation: {updated} fixed, {skipped} skipped")
    return updated, skipped
