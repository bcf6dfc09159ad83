"""EXIF extraction: persistent exiftool -> subprocess -> PIL.

The same 3-tier chain as the reference (processing/scorer.py:1540-1609 +
exiftool/exiftool_batch.py:16-163):

- single lookups (API-driven paths) go through one long-lived
  `exiftool -stay_open True -@ -` process — no per-call process spawn;
- batch scans use chunked subprocess calls (50 files per invocation, retry
  with doubled timeout) — cheaper than streaming thousands of files through
  the stay-open pipe;
- PIL's EXIF reader covers the standard fields when exiftool is absent.
"""

import atexit
import json
import select
import shutil
import subprocess
import threading

from PIL import Image
from PIL.ExifTags import TAGS

EXIFTOOL_BIN = shutil.which("exiftool")
_CHUNK = 50

_EXIFTOOL_ARGS = [
    "-json", "-n",
    "-DateTimeOriginal", "-CreateDate", "-Model", "-LensModel", "-LensID",
    "-ISO", "-Aperture", "-FNumber", "-ExposureTime", "-FocalLength",
    "-FocalLengthIn35mmFormat", "-FocalLengthIn35mmFilm",
    "-ImageWidth", "-ImageHeight",
]


class PersistentExifTool:
    """One `exiftool -stay_open True` process serving single lookups
    (reference: exiftool/exiftool_batch.py:16-89). Thread-safe; a hung or
    dead process is restarted on the next call."""

    def __init__(self, binary=None):
        self.binary = binary or EXIFTOOL_BIN
        self._proc = None
        self._lock = threading.Lock()
        self._seq = 0

    def _start(self):
        self._proc = subprocess.Popen(
            [self.binary, "-stay_open", "True", "-@", "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)

    def _stop(self):
        proc, self._proc = self._proc, None
        if proc is None:
            return
        try:
            proc.stdin.write(b"-stay_open\nFalse\n")
            proc.stdin.flush()
            proc.wait(timeout=2)
        except Exception:
            proc.kill()

    def close(self):
        with self._lock:
            self._stop()

    def execute(self, args, timeout=10.0):
        """Run one exiftool command; -> stdout bytes or None on failure."""
        with self._lock:
            if self._proc is None or self._proc.poll() is not None:
                try:
                    self._start()
                except Exception:
                    self._proc = None
                    return None
            self._seq += 1
            marker = f"{{ready{self._seq}}}".encode()
            try:
                command = "\n".join(args) + f"\n-execute{self._seq}\n"
                self._proc.stdin.write(command.encode())
                self._proc.stdin.flush()
                output = b""
                fd = self._proc.stdout.fileno()
                import time as _time

                deadline = _time.monotonic() + timeout
                while marker not in output:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("exiftool stay-open timeout")
                    ready, _, _ = select.select([fd], [], [], remaining)
                    if not ready:
                        raise TimeoutError("exiftool stay-open timeout")
                    chunk = self._proc.stdout.read1(65536)
                    if not chunk:
                        raise RuntimeError("exiftool stay-open EOF")
                    output += chunk
                return output.split(marker)[0]
            except Exception:
                self._stop()  # restart lazily on the next call
                return None


_persistent = None
_persistent_lock = threading.Lock()


def _get_persistent():
    global _persistent
    if EXIFTOOL_BIN is None:
        return None
    with _persistent_lock:
        if _persistent is None:
            _persistent = PersistentExifTool()
            atexit.register(_persistent.close)
        return _persistent

FIELDS = [
    "date_taken", "camera_model", "lens_model", "iso", "f_stop",
    "shutter_speed", "focal_length", "focal_length_35mm",
    "image_width", "image_height",
]


def _empty():
    return {f: None for f in FIELDS}


def get_exif_batch(paths, timeout=30):
    """{path: exif dict} for many files."""
    if EXIFTOOL_BIN:
        out = {}
        for i in range(0, len(paths), _CHUNK):
            chunk = paths[i:i + _CHUNK]
            out.update(_exiftool_chunk(chunk, timeout))
        return out
    return {p: get_exif_single(p) for p in paths}


def get_exif_single(path):
    """3-tier single lookup: stay-open process -> subprocess -> PIL."""
    tool = _get_persistent()
    if tool is not None:
        raw = tool.execute(_EXIFTOOL_ARGS + [path])
        if raw:
            try:
                records = json.loads(raw)
                if records:
                    return _standardize_exiftool(records[0])
            except ValueError:
                pass
    if EXIFTOOL_BIN:
        result = _exiftool_chunk([path], timeout=15)
        return result.get(path, _empty())
    return _pil_exif(path)


def _exiftool_chunk(paths, timeout):
    args = [EXIFTOOL_BIN] + _EXIFTOOL_ARGS + paths
    for attempt in (timeout, timeout * 2):
        try:
            proc = subprocess.run(args, capture_output=True, timeout=attempt)
            records = json.loads(proc.stdout or b"[]")
            out = {}
            for rec in records:
                out[rec.get("SourceFile")] = _standardize_exiftool(rec)
            return {p: out.get(p, _empty()) for p in paths}
        except subprocess.TimeoutExpired:
            continue
        except Exception:
            break
    return {p: _pil_exif(p) for p in paths}


def _standardize_exiftool(rec):
    """Field mapping matches the reference's parse_exif_data
    (exiftool/exiftool_batch.py:178-210, run with -j -n): CreateDate
    falls back for date_taken, Aperture precedes FNumber, and
    shutter_speed stores the NUMERIC seconds string (the viewer formats
    '1/250' for display) so databases from either implementation sort
    and mix cleanly."""
    exif = _empty()
    date = rec.get("DateTimeOriginal") or rec.get("CreateDate")
    exif["date_taken"] = str(date) if date else None
    exif["camera_model"] = rec.get("Model")
    exif["lens_model"] = rec.get("LensModel") or rec.get("LensID")
    exif["iso"] = _to_int(rec.get("ISO"))
    exif["f_stop"] = _to_float(rec.get("Aperture") or rec.get("FNumber"))
    et = _to_float(rec.get("ExposureTime"))
    exif["shutter_speed"] = str(et) if et else None
    exif["focal_length"] = _to_float(rec.get("FocalLength"))
    exif["focal_length_35mm"] = _to_float(
        rec.get("FocalLengthIn35mmFormat")
        or rec.get("FocalLengthIn35mmFilm"))
    exif["image_width"] = _to_int(rec.get("ImageWidth"))
    exif["image_height"] = _to_int(rec.get("ImageHeight"))
    return exif


def _pil_exif(path):
    exif = _empty()
    try:
        with Image.open(path) as img:
            exif["image_width"], exif["image_height"] = img.size
            raw = img.getexif()
            if not raw:
                return exif
            tags = {TAGS.get(k, k): v for k, v in raw.items()}
            ifd = {}
            try:
                ifd_raw = raw.get_ifd(0x8769)  # Exif SubIFD
                ifd = {TAGS.get(k, k): v for k, v in ifd_raw.items()}
            except Exception:
                pass
            merged = {**tags, **ifd}
            exif["date_taken"] = _to_str(merged.get("DateTimeOriginal")
                                         or merged.get("DateTime"))
            exif["camera_model"] = _to_str(merged.get("Model"))
            exif["lens_model"] = _to_str(merged.get("LensModel"))
            exif["iso"] = _to_int(merged.get("ISOSpeedRatings")
                                  or merged.get("PhotographicSensitivity"))
            exif["f_stop"] = _to_float(merged.get("FNumber"))
            et = _to_float(merged.get("ExposureTime"))
            exif["shutter_speed"] = str(et) if et else None
            exif["focal_length"] = _to_float(merged.get("FocalLength"))
            exif["focal_length_35mm"] = _to_int(merged.get("FocalLengthIn35mmFilm"))
    except Exception:
        pass
    return exif


def _to_float(v):
    try:
        if v is None:
            return None
        # PIL hands EXIF rationals through as (numerator, denominator)
        # tuples in some versions; IFDRational handles float() itself
        if isinstance(v, tuple) and len(v) == 2:
            return float(v[0]) / float(v[1]) if v[1] else None
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def _to_int(v):
    if isinstance(v, (tuple, list)) and v:
        v = v[0]
    try:
        if v is None:
            return None
        return int(v)
    except (TypeError, ValueError):
        return None


def _to_str(v):
    if v is None:
        return None
    s = str(v).strip().strip("\x00")
    return s or None
