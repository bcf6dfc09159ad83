"""Composition analysis: subject placement + leading lines.

Same scoring formulas as the reference (analyzers/composition.py:16-284).
Subject detection (adaptive Canny + contour scoring with a spectral-residual
saliency fallback) and Hough leading-lines stay on host OpenCV — they are
branchy geometry on small images, while the per-pixel metric suite runs on
device. The placement math is pure arithmetic:

- power points = thirds intersections; power score = max(0, 10 - dist*25);
- line score = max(0, 10 - (dx + dy)*15); center = max(0, 10 - (dx+dy)*10);
- final = max((2*power + 1*line)/3, center), weights config-driven;
- no subject: score 7.0 (assume decent centered composition), power 5.0;
- leading lines: blur -> Canny(50,150) -> HoughLinesP (min length 15% of the
  short side), diagonals (15-75 deg) get a 1.5x length bonus, score =
  min(10, mean_line_score * 2).
"""

import math

import cv2
import numpy as np


class CompositionAnalyzer:
    def __init__(self, config=None):
        self.power_weight = 2.0
        self.line_weight = 1.0
        if config is not None:
            weights = config.get_composition_weights()
            self.power_weight = weights.get("power_point_weight", 2.0)
            self.line_weight = weights.get("line_weight", 1.0)

    # ------------------------------------------------------ subject finding

    @staticmethod
    def detect_subject_region(rgb, gray=None):
        """Main-subject bbox [x1, y1, x2, y2] or None.

        Cascade: adaptive Canny contours scored by area x thirds-proximity,
        then spectral-residual saliency.
        """
        if rgb is None:
            return None
        h, w = rgb.shape[:2]
        if gray is None:
            gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)

        median_val = float(np.median(gray))
        edges = cv2.Canny(gray, int(max(0, 0.5 * median_val)),
                          int(min(255, 1.5 * median_val)))
        contours, _ = cv2.findContours(edges, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        min_area = h * w * 0.0001
        candidates = [c for c in contours if cv2.contourArea(c) > min_area]

        if candidates:
            thirds_x = (w / 3, 2 * w / 3)
            thirds_y = (h / 3, 2 * h / 3)
            best, best_score = None, 0.0
            for contour in candidates:
                moments = cv2.moments(contour)
                if moments["m00"] == 0:
                    continue
                cx = moments["m10"] / moments["m00"]
                cy = moments["m01"] / moments["m00"]
                area_score = cv2.contourArea(contour) / (h * w)
                dx = min(abs(cx - t) for t in thirds_x) / w
                dy = min(abs(cy - t) for t in thirds_y) / h
                score = area_score * (1 + max(0.0, 1 - (dx + dy)))
                if score > best_score:
                    best_score, best = score, contour
            if best is not None:
                x, y, bw, bh = cv2.boundingRect(best)
                return [x, y, x + bw, y + bh]

        try:  # saliency fallback (module availability varies by build)
            saliency = cv2.saliency.StaticSaliencySpectralResidual_create()
            ok, sal_map = saliency.computeSaliency(rgb)
            if ok:
                sal_u8 = (sal_map * 255).astype(np.uint8)
                _, thresh = cv2.threshold(sal_u8, 0, 255,
                                          cv2.THRESH_BINARY + cv2.THRESH_OTSU)
                contours, _ = cv2.findContours(thresh, cv2.RETR_EXTERNAL,
                                               cv2.CHAIN_APPROX_SIMPLE)
                if contours:
                    x, y, bw, bh = cv2.boundingRect(max(contours, key=cv2.contourArea))
                    return [x, y, x + bw, y + bh]
        except (cv2.error, AttributeError):
            pass
        return None

    # ----------------------------------------------------------- placement

    def placement_data(self, bbox, img_w, img_h, rgb=None):
        """Composition score block for a subject bbox (or auto-detected)."""
        if bbox is None and rgb is not None:
            bbox = self.detect_subject_region(rgb)
        if bbox is None:
            return {"score": 7.0, "power_point_score": 5.0,
                    "line_score": 5.0, "center_score": 7.0}

        cx = (bbox[0] + bbox[2]) / 2 / img_w
        cy = (bbox[1] + bbox[3]) / 2 / img_h
        thirds = (1 / 3, 2 / 3)

        power_dist = min(math.hypot(cx - px, cy - py)
                         for px in thirds for py in thirds)
        power_score = max(0.0, 10 - power_dist * 25)

        dx = min(abs(cx - t) for t in thirds)
        dy = min(abs(cy - t) for t in thirds)
        line_score = max(0.0, 10 - (dx + dy) * 15)

        center_score = max(0.0, 10 - (abs(cx - 0.5) + abs(cy - 0.5)) * 10)

        weighted = ((power_score * self.power_weight + line_score * self.line_weight)
                    / (self.power_weight + self.line_weight))
        return {
            "score": round(max(weighted, center_score), 2),
            "power_point_score": round(power_score, 2),
            "line_score": round(line_score, 2),
            "center_score": round(center_score, 2),
        }

    # -------------------------------------------------------- leading lines

    @staticmethod
    def detect_leading_lines(rgb, gray=None):
        if rgb is None:
            return {"leading_lines_score": 0, "line_count": 0}
        h, w = rgb.shape[:2]
        if gray is None:
            gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        blurred = cv2.GaussianBlur(gray, (5, 5), 0)
        edges = cv2.Canny(blurred, 50, 150)
        lines = cv2.HoughLinesP(edges, 1, np.pi / 180, 80,
                                minLineLength=int(min(h, w) * 0.15), maxLineGap=20)
        if lines is None:
            return {"leading_lines_score": 0, "line_count": 0}

        diagonal = math.hypot(h, w)
        total = 0.0
        segments = np.asarray(lines).reshape(-1, 4)
        for x1, y1, x2, y2 in segments:
            length = math.hypot(x2 - x1, y2 - y1)
            angle = 90.0 if x2 == x1 else abs(math.degrees(
                math.atan((y2 - y1) / (x2 - x1))))
            bonus = 1.5 if 15 <= angle <= 75 else 1.0
            total += (length / diagonal) * 10 * bonus
        score = min(10.0, total / max(1, len(segments)) * 2)
        return {"leading_lines_score": round(score, 2), "line_count": len(segments)}

    @staticmethod
    def integrate_leading_lines(base_score, leading_lines_score, has_faces):
        """Leading lines add up to +2.0 for photos without faces."""
        if has_faces:
            return base_score
        return min(10.0, base_score + min(2.0, leading_lines_score / 5.0))

    def analyze(self, rgb, face_bbox=None):
        """Full composition block for one image."""
        h, w = rgb.shape[:2]
        gray = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        placement = self.placement_data(face_bbox, w, h, rgb=rgb)
        lines = self.detect_leading_lines(rgb, gray)
        return {**placement, **lines}
