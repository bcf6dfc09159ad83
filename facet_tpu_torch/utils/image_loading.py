"""Image decoding: PIL for JPEG/PNG/etc, rawpy for Canon RAW when available.

Reference behavior (utils/image_loading.py:44-106): EXIF orientation applied
at load, RAW files decode via embedded thumbnail first with full demosaic as
fallback, a module lock serializes libraw. rawpy is optional here — without
it RAW files are skipped with a warning (zero-egress environments).
"""

import os
import threading
import warnings

import numpy as np
from PIL import Image, ImageOps

JPEG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".webp", ".bmp", ".tif", ".tiff"}
RAW_EXTENSIONS = {".cr2", ".cr3", ".nef", ".arw", ".dng", ".orf", ".rw2"}
SUPPORTED_EXTENSIONS = JPEG_EXTENSIONS | RAW_EXTENSIONS

try:  # optional native RAW decoder
    import rawpy  # type: ignore

    _HAS_RAWPY = True
except ImportError:
    rawpy = None
    _HAS_RAWPY = False

_rawpy_lock = threading.Lock()  # libraw is not thread-safe


def is_raw(path):
    return os.path.splitext(path)[1].lower() in RAW_EXTENSIONS


def load_image(path):
    """Load any supported image -> PIL RGB with EXIF orientation applied.

    Returns None on failure (the engine records an error row and continues).
    """
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext in RAW_EXTENSIONS:
            return _load_raw(path)
        img = Image.open(path)
        img = ImageOps.exif_transpose(img)
        return img.convert("RGB")
    except Exception as exc:
        warnings.warn(f"failed to load {path}: {exc}")
        return None


def _load_raw(path):
    if not _HAS_RAWPY:
        warnings.warn(f"rawpy unavailable, skipping RAW file {path}")
        return None
    with _rawpy_lock:
        with rawpy.imread(path) as raw:
            try:  # fast path: embedded JPEG thumbnail
                thumb = raw.extract_thumb()
                if thumb.format == rawpy.ThumbFormat.JPEG:
                    import io

                    img = Image.open(io.BytesIO(thumb.data))
                    return ImageOps.exif_transpose(img).convert("RGB")
            except Exception:
                pass
            rgb = raw.postprocess(use_camera_wb=True, output_bps=8)
            return Image.fromarray(rgb)


def load_image_rgb(path):
    """Load -> RGB uint8 numpy array (H, W, 3), or None."""
    img = load_image(path)
    if img is None:
        return None
    return np.asarray(img, dtype=np.uint8)


def gather_image_files(directory, skip_hidden=True, skip_raw_with_jpeg=True):
    """Recursive walk collecting scannable files.

    Reference semantics (photos.py:794-835): hidden directories pruned, a RAW
    file is skipped when a JPEG with the same stem exists next to it.
    """
    found = []
    for root, dirs, files in os.walk(directory):
        if skip_hidden:
            dirs[:] = [d for d in dirs if not d.startswith(".")]
        stems_with_jpeg = set()
        if skip_raw_with_jpeg:
            for f in files:
                stem, ext = os.path.splitext(f)
                if ext.lower() in JPEG_EXTENSIONS:
                    stems_with_jpeg.add(stem.lower())
        for f in sorted(files):
            if f.startswith("."):
                continue
            stem, ext = os.path.splitext(f)
            ext = ext.lower()
            if ext not in SUPPORTED_EXTENSIONS:
                continue
            if ext in RAW_EXTENSIONS and skip_raw_with_jpeg and stem.lower() in stems_with_jpeg:
                continue
            found.append(os.path.join(root, f))
    return found
