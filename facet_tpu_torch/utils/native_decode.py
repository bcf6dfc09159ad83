"""ctypes binding for the native parallel JPEG decoder (native/facet_io.cpp).

Build once with `make -C native`; without the .so every caller falls back to
PIL transparently. The native path decodes batches across threads, applies
EXIF orientation, and can decode directly at a bounded resolution via
libjpeg's fractional DCT scaling.
"""

import ctypes
import os

import numpy as np

_LIB = None
_SEARCH_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libfacet_io.so"),
    "libfacet_io.so",
]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for path in _SEARCH_PATHS:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.facet_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.facet_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.facet_io_version.restype = ctypes.c_int
        if lib.facet_io_version() >= 2:
            lib.facet_encode_thumbnail_batch.argtypes = [
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
        return lib
    _LIB = False
    return False


def available():
    return bool(_load())


def decode_jpeg_batch(paths, max_long_edge=0, n_threads=0):
    """Decode JPEGs in parallel -> list of RGB uint8 arrays (None on failure).

    Returns None entirely when the native library isn't built.
    """
    lib = _load()
    if not lib or not paths:
        return None
    count = len(paths)
    c_paths = (ctypes.c_char_p * count)(
        *[os.fsencode(p) for p in paths])
    rgb = (ctypes.POINTER(ctypes.c_uint8) * count)()
    widths = (ctypes.c_int * count)()
    heights = (ctypes.c_int * count)()
    ok = (ctypes.c_int * count)()
    lib.facet_decode_jpeg_batch(c_paths, count, max_long_edge, n_threads,
                                rgb, widths, heights, ok)
    out = []
    for i in range(count):
        if not ok[i] or not rgb[i]:
            out.append(None)
            continue
        h, w = heights[i], widths[i]
        buf = ctypes.cast(rgb[i], ctypes.POINTER(ctypes.c_uint8 * (h * w * 3)))
        arr = np.frombuffer(buf.contents, dtype=np.uint8).reshape(h, w, 3).copy()
        lib.facet_free(rgb[i])
        out.append(arr)
    return out


def encode_available():
    lib = _load()
    return bool(lib) and lib.facet_io_version() >= 2


def encode_thumbnail_batch(arrays, size=640, quality=80, n_threads=0):
    """RGB uint8 arrays -> list of JPEG bytes (None entries on failure),
    resized to `size` long edge (area average) and encoded across threads
    in C (native/facet_io.cpp facet_encode_thumbnail_batch).

    Returns None entirely when the native library isn't built or predates
    the encoder — callers fall back to the PIL path per image.
    """
    if not encode_available() or not arrays:
        return None
    lib = _load()
    count = len(arrays)
    # keep C-contiguous copies alive for the duration of the call
    contig = [np.ascontiguousarray(a, dtype=np.uint8) for a in arrays]
    rgb = (ctypes.POINTER(ctypes.c_uint8) * count)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for a in contig])
    widths = (ctypes.c_int * count)(*[a.shape[1] for a in contig])
    heights = (ctypes.c_int * count)(*[a.shape[0] for a in contig])
    out_buf = (ctypes.POINTER(ctypes.c_uint8) * count)()
    out_len = (ctypes.c_int * count)()
    ok = (ctypes.c_int * count)()
    lib.facet_encode_thumbnail_batch(rgb, widths, heights, count, size,
                                     quality, n_threads, out_buf, out_len, ok)
    out = []
    for i in range(count):
        if not ok[i] or not out_buf[i]:
            out.append(None)
            continue
        buf = ctypes.cast(out_buf[i],
                          ctypes.POINTER(ctypes.c_uint8 * out_len[i]))
        out.append(bytes(buf.contents))
        lib.facet_free(out_buf[i])
    return out
