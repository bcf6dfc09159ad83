"""Technical image metrics: float64 host epilogues over device statistics.

Carried over from ``facet_tpu/analyzers/technical.py`` unchanged in its
formulas (the reference implementation's values, analyzers/
technical.py:29-342 there), because that module imports the JAX statistics
at the top. The per-pixel work comes from ``facet_tpu_torch.ops.stats``;
integer histograms keep the host math exact:

- sharpness:      Laplacian variance, normalized min(10, var/50)
- color harmony:  H-S joint entropy * 10 / 15.5, capped at 10
- histogram data: 256-bin normalized histogram blob + spread, mean
                  luminance, shadow/highlight clipping, silhouette
                  heuristic, kurtosis bimodality, exposure score
- monochrome:     mean saturation < threshold
- dynamic range:  log2(p98 / max(p2,1)) stops
- noise:          Immerkaer estimate sum|conv| * sqrt(pi/2) / (6(w-2)(h-2))
- contrast:       (p95-p5)/255*5 + std/255*20, capped at 10
"""

import math
import struct

import numpy as np

from facet_tpu_torch.ops.stats import ImageStats

_BIN_VALUES = np.arange(256, dtype=np.float64)


def _percentile_from_hist(counts, q):
    """np.percentile (linear interpolation) over the raw pixel population,
    computed exactly from its value histogram."""
    n = int(counts.sum())
    if n == 0:
        return 0.0
    cum = np.cumsum(counts)
    pos = (n - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    v_lo = float(np.searchsorted(cum, lo + 1))
    if hi == lo:
        return v_lo
    v_hi = float(np.searchsorted(cum, hi + 1))
    return v_lo + (pos - lo) * (v_hi - v_lo)


def _moments_from_hist(counts, values):
    """(n, mean, population variance) in float64 from an integer histogram."""
    n = counts.sum(dtype=np.float64)
    if n == 0:
        return 0.0, 0.0, 0.0
    mean = float(np.dot(counts, values) / n)
    var = float(np.dot(counts, (values - mean) ** 2) / n)
    return float(n), mean, var


def recompute_exposure_score(blob, stored_bimodality, is_silhouette):
    """The reference's --recompute-average exposure refresh, exactly
    (processing/scorer.py:1250-1270): spread/luminance re-derived from the
    stored 256-float histogram blob, but the bimodality PENALTY uses the
    STORED column value and the silhouette exemption uses the stored flag;
    clipping masses use the fixed 30/225 bins. Returns the refreshed score
    or None for malformed blobs."""
    if blob is None or len(blob) != 256 * 4:
        return None
    hist = np.frombuffer(blob, dtype=np.float32)
    total = float(hist.sum())
    if total <= 0:
        return None
    norm = hist.astype(np.float64) / total
    mean_luminance = float(np.sum(np.arange(256) * norm)) / 255.0
    variance = float(np.sum(((np.arange(256) / 255.0 - mean_luminance) ** 2)
                            * norm))
    spread = (variance ** 0.5) * 255.0
    shadow_mass = float(norm[:30].sum())
    highlight_mass = float(norm[225:].sum())
    bimodality = stored_bimodality or 0
    luminance_penalty = abs(mean_luminance - 0.5) * 8
    spread_bonus = min(4.0, spread / 20.0)
    bimodality_penalty = max(0, bimodality - 1.0) * 0.6
    clip_pen = 0.0
    if not is_silhouette:
        clip_pen = shadow_mass * 4.0 + highlight_mass * 5.0
    return max(0.0, min(10.0, 7.0 - luminance_penalty + spread_bonus
                        - bimodality_penalty - clip_pen))


class TechnicalAnalyzer:
    """Technical metrics from one image's device statistics.

    Thresholds come from the scoring config when provided, matching the
    reference's wiring (shadow/highlight clip percents, monochrome saturation
    percent).
    """

    def __init__(self, config=None):
        if config is not None:
            exposure = config.get_exposure_settings()
            self.shadow_threshold = exposure.get("shadow_clip_threshold_percent", 15) / 100
            self.highlight_threshold = exposure.get("highlight_clip_threshold_percent", 10) / 100
            mono = config.get_monochrome_settings()
            self.monochrome_threshold = mono.get("saturation_threshold_percent", 10) / 100
        else:
            self.shadow_threshold = 0.15
            self.highlight_threshold = 0.10
            self.monochrome_threshold = 0.10

    def metrics_from_stats(self, stats: ImageStats):
        """Full metric dict with photos-table column names."""
        sharp = self.sharpness_data(stats)
        color = self.color_harmony_data(stats)
        hist = self.histogram_data(stats)
        out = {
            "raw_sharpness_variance": sharp["raw_variance"],
            "tech_sharpness": sharp["normalized"],
            "raw_color_entropy": color["raw_entropy"],
            "color_score": color["normalized"],
            "histogram_data": hist["histogram_bytes"],
            "histogram_spread": hist["spread"],
            "mean_luminance": hist["mean_luminance"],
            "histogram_bimodality": hist["bimodality"],
            "exposure_score": hist["exposure_score"],
            "shadow_clipped": hist["shadow_clipped"],
            "highlight_clipped": hist["highlight_clipped"],
            "is_silhouette": hist["is_silhouette"],
        }
        out.update(self.monochrome_data(stats))
        out.update(self.dynamic_range(stats))
        out.update(self.noise_estimate(stats))
        out.update(self.contrast_score(stats))
        return out

    # ------------------------------------------------------------- metrics

    @staticmethod
    def sharpness_data(stats):
        var = stats.laplacian_variance()
        return {
            "raw_variance": var,
            "normalized": float(min(10.0, var / 50.0)),
        }

    @staticmethod
    def color_harmony_data(stats):
        entropy = float(stats.hs_entropy)
        return {
            "raw_entropy": entropy,
            "normalized": float(min(10.0, entropy * 10.0 / 15.5)),
        }

    def histogram_data(self, stats):
        counts = stats.gray_hist.astype(np.float64)
        total = counts.sum()
        # mimic the reference dtype path: calcHist returns float32 counts
        hist_f32 = stats.gray_hist.astype(np.float32)
        total_f32 = hist_f32.sum()
        hist_norm_f32 = hist_f32 / total_f32 if total_f32 > 0 else hist_f32
        histogram_bytes = struct.pack("256f", *hist_norm_f32)

        hist_norm = counts / total if total > 0 else counts
        mean_val = float(np.sum(_BIN_VALUES * hist_norm))
        spread = float(np.sqrt(np.sum(((_BIN_VALUES - mean_val) ** 2) * hist_norm)))
        mean_luminance = mean_val / 255.0

        shadow_mass = float(hist_norm[:30].sum())
        highlight_mass = float(hist_norm[225:].sum())
        shadow_clipped = 1 if shadow_mass > self.shadow_threshold else 0
        highlight_clipped = 1 if highlight_mass > self.highlight_threshold else 0

        # Backlit-subject heuristic: heavy shadows AND strong highlights
        lower_third = float(hist_norm[:85].sum())
        upper_third = float(hist_norm[170:].sum())
        is_silhouette = 1 if (lower_third > 0.35 and upper_third > 0.25) else 0

        try:
            from scipy.stats import kurtosis

            bimodality = float(-kurtosis(hist_norm_f32 * 256, fisher=True))
        except (ImportError, ValueError):
            bimodality = 0.0

        luminance_penalty = abs(mean_luminance - 0.5) * 8
        spread_bonus = min(4.0, spread / 20.0)
        bimodality_penalty = max(0.0, bimodality - 1.0) * 0.6
        clipping_penalty = 0.0
        if not is_silhouette:
            clipping_penalty = shadow_mass * 4.0 + highlight_mass * 5.0
        exposure_score = max(
            0.0,
            min(10.0, 7.0 - luminance_penalty + spread_bonus
                - bimodality_penalty - clipping_penalty),
        )

        return {
            "histogram_bytes": histogram_bytes,
            "spread": round(spread, 4),
            "mean_luminance": round(mean_luminance, 4),
            "bimodality": round(bimodality, 4),
            "exposure_score": round(exposure_score, 2),
            "shadow_clipped": shadow_clipped,
            "highlight_clipped": highlight_clipped,
            "is_silhouette": is_silhouette,
        }

    def monochrome_data(self, stats):
        mean_sat = stats.mean_saturation()
        return {
            "is_monochrome": 1 if mean_sat < self.monochrome_threshold else 0,
            "mean_saturation": round(mean_sat, 4),
        }

    @staticmethod
    def dynamic_range(stats):
        counts = stats.gray_hist
        p2 = _percentile_from_hist(counts, 2)
        p98 = _percentile_from_hist(counts, 98)
        if p2 < 1:
            p2 = 1.0
        stops = float(np.log2(max(p98, 1.0) / p2))
        return {"dynamic_range_stops": round(stops, 2)}

    @staticmethod
    def noise_estimate(stats):
        h, w = stats.height, stats.width
        if h <= 2 or w <= 2:
            return {"noise_sigma": 0.0}
        sigma = stats.imm_abs_sum * math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2))
        return {"noise_sigma": round(sigma, 2)}

    @staticmethod
    def contrast_score(stats):
        counts = stats.gray_hist
        p5 = _percentile_from_hist(counts, 5)
        p95 = _percentile_from_hist(counts, 95)
        percentile_contrast = (p95 - p5) / 255.0
        _, _, var = _moments_from_hist(counts.astype(np.float64), _BIN_VALUES)
        rms = math.sqrt(var) / 255.0
        score = min(10.0, percentile_contrast * 5.0 + rms * 20.0)
        return {
            "contrast_score": round(score, 2),
            "percentile_contrast": round(percentile_contrast, 4),
            "rms_contrast": round(rms, 4),
        }
