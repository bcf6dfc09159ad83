"""FacePipeline: detection -> alignment -> landmarks -> embeddings, batched.

Counterpart of ``facet_tpu/models/face_pipeline.py``, with the same metric
contract:

- confidence (>= min_confidence) and min-size filtering;
- per face: quality = det_score * 10, eye sharpness = Laplacian variance of
  the two eye ROIs (landmarks 38/92, offset 0.15 x eye distance) over mean
  intensity, /2 capped at 10; face-crop sharpness; a 128 px JPEG thumbnail;
- per photo: quality = 0.7 * min + 0.3 * mean, eye and face sharpness
  averaged, ANY blink flags the photo, the combined bbox, a group from N
  faces;
- EAR blink on the 106 landmarks (L[35,39,37,38,41,40],
  R[89,93,91,92,95,94]).

Device work: the letterbox resize, padding, ``(x - 127.5) / 128``, SCRFD
and the top-k decode run as one function of the resident uint8 batch
(``_detect_program``; it rides the fused pass in
``processing/device_pipeline.py``), and every face crop of a batch goes
through ArcFace and the landmark net in one call each, all in full float32.
The crops, NMS and per-face statistics are host work (numpy, cv2, PIL), as
in the JAX package.

Not ported: the exact 2d106det graph that the JAX package runs when a
converted ``landmark_106_graph.npz`` is installed. ``LandmarkNet``
computes something else, so with that file present the pipeline refuses
to start instead of using it.
"""

import io
import os
from dataclasses import replace

import cv2
import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from facet_tpu_torch import params as P
from facet_tpu_torch.models.face_models import (
    ARCFACE_DST,
    IResNet,
    LandmarkNet,
    nms,
    topk_to_detections,
    umeyama_similarity,
)
from facet_tpu_torch.models.scrfd import SCRFD, SCRFD_10G, decode_topk
from facet_tpu_torch.ops.precision import full_float32
from facet_tpu_torch.ops.resize import resample_matrix
from facet_tpu_torch.processing.device_pipeline import rider_slice_size

# fast speed tier (processing.speed_tier: "fast"): 448 px detection canvas;
# must stay a multiple of the largest anchor stride (32)
FAST_TIER_DET_SIZE = 448
LANDMARK_GRAPH = "landmark_106_graph"
# Activation bytes of one image per pixel of the detection canvas (SCRFD
# det_10g and its decode in f32), for the detection's slice size
# (processing/device_pipeline.py:rider_slice_size): 96 measured at 640 px
# on an H100 80GB HBM3 at 700 W (chip_smoke.py --probe), rounded up to a
# power of two.
DET_ACT_BYTES_PER_INPUT_PIXEL = 128

LEFT_EYE = [35, 39, 37, 38, 41, 40]
RIGHT_EYE = [89, 93, 91, 92, 95, 94]

EMPTY_RESULT = {
    "face_count": 0, "face_quality": 0, "eye_sharpness": 0, "is_blink": 0,
    "face_ratio": 0.0, "combined_bbox": None, "face_sharpness": 0,
    "raw_eye_sharpness": 0, "confidence": 0.0, "rows": [],
}


def calculate_ear(landmarks, indices):
    v1 = np.linalg.norm(landmarks[indices[2]] - landmarks[indices[4]])
    v2 = np.linalg.norm(landmarks[indices[3]] - landmarks[indices[5]])
    h = np.linalg.norm(landmarks[indices[0]] - landmarks[indices[1]])
    return (v1 + v2) / (2.0 * h) if h > 0 else 0.3


def average_ear(landmarks):
    return (calculate_ear(landmarks, LEFT_EYE) + calculate_ear(landmarks, RIGHT_EYE)) / 2.0


def check_no_landmark_graph():
    """Refuse to run when the exact 2d106det graph is installed: its runner
    is not ported, and LandmarkNet is a different function."""
    path = os.path.join(P.PRETRAINED_DIR, f"{LANDMARK_GRAPH}.npz")
    if os.path.exists(path):
        raise NotImplementedError(
            f"{path} holds the exact 2d106det landmark graph, whose runner is not "
            f"ported to facet_tpu_torch yet (ROADMAP.md Queue 1 #2); the port "
            f"will not replace it with LandmarkNet")


class FacePipeline:
    def __init__(self, detector, landmark_net, embedder, device, config=None):
        check_no_landmark_graph()
        self.device = torch.device(device)
        self.detector = detector.to(self.device).eval()
        self.landmark_net = landmark_net.to(self.device).eval()
        self.embedder = embedder.to(self.device).eval()
        self.det_config = detector.config

        settings = config.get_face_detection_settings() if config else {}
        self.min_confidence = settings.get("min_confidence_percent", 70) / 100
        self.min_face_size = settings.get("min_face_size", 30)
        # detector candidate threshold before NMS (insightface det_thresh);
        # the photo-level min_confidence filters again after
        self.score_threshold = 0.5
        self.top_k = 64              # candidates per image the decode keeps
        self.blink_threshold = settings.get("blink_ear_threshold", 0.21)
        self.group_min = settings.get("min_faces_for_group", 4)
        fp = config.get_face_processing_settings() if config else {}
        self.crop_padding = fp.get("crop_padding", 0.3)
        self._detect_programs = {}   # (h, w) -> (letterbox + detect + decode, scale)

    # -------------------------------------------------------------- factory

    @classmethod
    def create(cls, config, cached, device):
        """Host cache > converted checkpoints > fallback init (SCRFD seed
        10, landmarks 11, ArcFace 12); the fast tier detects on a 448 px
        canvas with the same parameters."""
        check_no_landmark_graph()
        det_config = SCRFD_10G
        if config is not None and config.speed_tier() == "fast":
            det_config = replace(det_config, input_size=FAST_TIER_DET_SIZE)
        detector, landmark_net, embedder = SCRFD(det_config), LandmarkNet(), IResNet()
        if cached is not None:
            detector.load_state_dict(cached["det"])
            landmark_net.load_state_dict(cached["landmark"])
            embedder.load_state_dict(cached["embed"])
        else:
            P.init_or_load(detector, "scrfd_detector", seed=10)
            P.init_or_load(landmark_net, "landmark_106", seed=11)
            P.init_or_load(embedder, "arcface_iresnet50", seed=12)
        return cls(detector, landmark_net, embedder, device, config)

    def host_params(self):
        return {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
                for name, net in (("det", self.detector), ("landmark", self.landmark_net),
                                  ("embed", self.embedder))}

    # ------------------------------------------------------------ detection

    def _detect_program(self, h, w):
        """-> (run, scale): ``run`` takes the resident (B, h, w, 3) uint8
        batch and returns the un-fetched top-k (scores, boxes, kps5) of
        each image on the letterboxed canvas; ``scale`` maps the canvas
        back to the image."""
        key = (h, w)
        if key not in self._detect_programs:
            size = self.det_config.input_size
            scale = size / max(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            rows = torch.from_numpy(resample_matrix(h, nh, method="linear")).to(self.device)
            cols = torch.from_numpy(resample_matrix(w, nw, method="linear")).to(self.device)
            cap = rider_slice_size(self.device, h, w, size, DET_ACT_BYTES_PER_INPUT_PIXEL)

            @torch.no_grad()
            def detect(batch_u8):
                with full_float32():
                    x = batch_u8.to(torch.float32)
                    x = torch.einsum("rh,bhwc->brwc", rows, x)
                    x = torch.einsum("sw,brwc->brsc", cols, x)
                    canvas = F.pad(x, (0, 0, 0, size - nw, 0, size - nh))
                    canvas = (canvas - 127.5) / 128.0
                    return decode_topk(self.detector(canvas), k=self.top_k)

            def run(dev):
                outs = [detect(dev[i:i + cap]) for i in range(0, dev.shape[0], cap)]
                return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

            self._detect_programs[key] = (run, scale)
        return self._detect_programs[key]

    def decode_detections(self, det_out, scale, n):
        """Fetched (top, boxes, kps5) for the first ``n`` rows -> per image:
        list of dicts {score, bbox, kps} in image coordinates (threshold
        and NMS on the host, like insightface)."""
        top, boxes, kps5 = det_out
        decoded = topk_to_detections(np.asarray(top)[:n], np.asarray(boxes)[:n],
                                     np.asarray(kps5)[:n],
                                     score_threshold=self.score_threshold)
        out = []
        for dets in decoded:
            kept = nms(dets)
            out.append([{"score": score, "bbox": bbox / scale, "kps": kps / scale}
                        for score, bbox, kps in kept])
        return out

    def detect_batch(self, images):
        """-> per image: list of dicts {score, bbox, kps} in image coords."""
        boxes_out = [None] * len(images)
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape[:2], []).append(i)
        for (h, w), idxs in by_shape.items():
            run, scale = self._detect_program(h, w)
            batch = torch.from_numpy(np.stack([images[i] for i in idxs])).to(self.device)
            det_out = [t.cpu().numpy() for t in run(batch)]
            for i, dets in zip(idxs, self.decode_detections(det_out, scale, len(idxs))):
                boxes_out[i] = dets
        return boxes_out

    # -------------------------------------------------------------- crops

    @torch.no_grad()
    def _embed(self, aligned):
        """(N, 112, 112, 3) float32 crops in [-1, 1] -> (N, 512) numpy."""
        with full_float32():
            return self.embedder(torch.from_numpy(aligned).to(self.device)).cpu().numpy()

    @torch.no_grad()
    def _run_landmarks(self, crops_u8):
        """(N, 192, 192, 3) uint8 crops -> (N, 106, 2) crop-space coords."""
        x = (crops_u8.astype(np.float32) - 127.5) / 127.5
        with full_float32():
            return self.landmark_net(torch.from_numpy(x).to(self.device)).cpu().numpy()

    # ------------------------------------------------------------- analysis

    def analyze_batch(self, images, detections=None):
        """RGB uint8 arrays -> list of photo-level face dicts (contract
        above). ``detections`` skips the detection stage when the caller
        already ran it on the resident batch (the fused pass does)."""
        if detections is None:
            detections = self.detect_batch(images)

        jobs = []  # (img_idx, face_idx, det)
        for i, faces in enumerate(detections):
            kept = []
            for det in faces:
                if det["score"] < self.min_confidence:
                    continue
                x1, y1, x2, y2 = det["bbox"]
                if (x2 - x1) < self.min_face_size or (y2 - y1) < self.min_face_size:
                    continue
                kept.append(det)
            for j, det in enumerate(kept):
                jobs.append((i, j, det))

        if jobs:
            aligned = np.stack([self._align_crop(images[i], det["kps"])
                                for i, _, det in jobs])
            lmk_crops, lmk_meta = [], []
            for i, _, det in jobs:
                crop, meta = self._landmark_crop(images[i], det["bbox"])
                lmk_crops.append(crop)
                lmk_meta.append(meta)
            embeddings = self._embed(aligned)
            lmk_out = self._run_landmarks(np.stack(lmk_crops))
        results = []
        job_pos = 0
        for i, image in enumerate(images):
            my_jobs = []
            while (job_pos + len(my_jobs) < len(jobs)
                   and jobs[job_pos + len(my_jobs)][0] == i):
                my_jobs.append(jobs[job_pos + len(my_jobs)])
            if not my_jobs:
                results.append(dict(EMPTY_RESULT))
                continue
            faces = []
            for k, (_, _, det) in enumerate(my_jobs):
                idx = job_pos + k
                center, size = lmk_meta[idx]
                lmk = lmk_out[idx] / 192.0 * size + (center - size / 2.0)
                faces.append({"det": det, "embedding": embeddings[idx],
                              "landmarks": lmk.astype(np.float32)})
            job_pos += len(my_jobs)
            results.append(self._aggregate(image, faces))
        return results

    # --------------------------------------------------------------- helpers

    @staticmethod
    def _align_crop(image, kps5):
        m = umeyama_similarity(kps5.astype(np.float32), ARCFACE_DST)
        warped = cv2.warpAffine(image, m, (112, 112), borderValue=0)
        return (warped.astype(np.float32) - 127.5) / 127.5

    @staticmethod
    def _landmark_crop(image, bbox):
        h, w = image.shape[:2]
        cx = (bbox[0] + bbox[2]) / 2
        cy = (bbox[1] + bbox[3]) / 2
        size = max(bbox[2] - bbox[0], bbox[3] - bbox[1]) * 1.5
        x1 = int(round(cx - size / 2))
        y1 = int(round(cy - size / 2))
        crop = np.zeros((int(size) + 1, int(size) + 1, 3), np.uint8)
        sx1, sy1 = max(0, x1), max(0, y1)
        sx2 = min(w, x1 + crop.shape[1])
        sy2 = min(h, y1 + crop.shape[0])
        if sx2 > sx1 and sy2 > sy1:
            crop[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = image[sy1:sy2, sx1:sx2]
        resized = cv2.resize(crop, (192, 192))
        return resized, (np.array([cx, cy], np.float32), float(size))

    def _crop_thumbnail(self, image, bbox, size=128, quality=85):
        h, w = image.shape[:2]
        bw, bh = bbox[2] - bbox[0], bbox[3] - bbox[1]
        pad_x, pad_y = bw * self.crop_padding, bh * self.crop_padding
        x1 = int(max(0, bbox[0] - pad_x))
        y1 = int(max(0, bbox[1] - pad_y))
        x2 = int(min(w, bbox[2] + pad_x))
        y2 = int(min(h, bbox[3] + pad_y))
        crop = image[y1:y2, x1:x2]
        if crop.size == 0:
            return None
        pil = Image.fromarray(crop)
        pil.thumbnail((size, size))
        buf = io.BytesIO()
        pil.save(buf, "JPEG", quality=quality)
        return buf.getvalue()

    def _eye_sharpness(self, image, gray, landmarks):
        h, w = image.shape[:2]
        l_eye, r_eye = landmarks[38], landmarks[92]
        eye_dist = np.linalg.norm(l_eye - r_eye)
        offset = int(eye_dist * 0.15)
        scores = []
        for ex, ey in (l_eye, r_eye):
            x1, x2 = int(ex - offset), int(ex + offset)
            y1, y2 = int(ey - offset), int(ey + offset)
            roi = gray[max(0, y1):min(h, y2), max(0, x1):min(w, x2)]
            if roi.size > 0:
                scores.append(cv2.Laplacian(roi, cv2.CV_64F).var()
                              / (float(np.mean(roi)) + 1))
        return max(scores) if scores else 0.0

    def _aggregate(self, image, faces):
        h, w = image.shape[:2]
        gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)

        qualities, eye_scores, raw_eyes, sharpness = [], [], [], []
        any_blink = False
        total_area = 0
        min_x, min_y, max_x, max_y = w, h, 0, 0
        rows = []
        for idx, face in enumerate(faces):
            det = face["det"]
            bbox = det["bbox"].astype(int)
            min_x, min_y = min(min_x, bbox[0]), min(min_y, bbox[1])
            max_x, max_y = max(max_x, bbox[2]), max(max_y, bbox[3])
            qualities.append(det["score"] * 10)

            raw_eye = self._eye_sharpness(image, gray, face["landmarks"])
            eye_scores.append(min(10.0, raw_eye / 2.0))
            raw_eyes.append(raw_eye)

            crop = gray[max(0, bbox[1]):min(h, bbox[3]), max(0, bbox[0]):min(w, bbox[2])]
            sharpness.append(cv2.Laplacian(crop, cv2.CV_64F).var() if crop.size else 0.0)

            if average_ear(face["landmarks"]) < self.blink_threshold:
                any_blink = True
            total_area += (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])

            rows.append({
                "face_index": idx,
                "bbox": [int(v) for v in bbox],
                "confidence": float(det["score"]),
                "embedding": face["embedding"].astype(np.float32).tobytes(),
                "landmarks": face["landmarks"].astype(np.float32).tobytes(),
                "thumbnail": self._crop_thumbnail(image, bbox),
            })

        face_quality = round(0.7 * min(qualities) + 0.3 * (sum(qualities) / len(qualities)), 2)
        return {
            "face_count": len(faces),
            "face_quality": face_quality,
            "eye_sharpness": round(sum(eye_scores) / len(eye_scores), 2),
            "raw_eye_sharpness": sum(raw_eyes) / len(raw_eyes),
            "face_sharpness": sum(sharpness) / len(sharpness),
            "is_blink": 1 if any_blink else 0,
            "face_ratio": min(1.0, total_area / (h * w)),
            "combined_bbox": [min_x, min_y, max_x, max_y],
            "confidence": max(f["det"]["score"] for f in faces),
            "rows": rows,
        }
