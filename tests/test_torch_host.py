"""The port's copies of facet_tpu's host modules against their originals.

facet_tpu_torch keeps its own copies of the database layer, the scoring
config, the image/thumbnail/tag utilities, the scoring brain and the
composition analyzer, so that it imports nothing of facet_tpu. These tests
hold each copy to the original on the same inputs, so the two cannot drift
apart: identical schema SQL, identical default config, and identical
outputs of the brain, the composition analyzer, the category filters and
the percentile normalizer.
"""

import io

import numpy as np
import pytest


def _metrics(seed):
    """A photo's metric dict for the brain, seeded."""
    rng = np.random.default_rng(seed)
    m = {k: float(rng.uniform(0, 10)) for k in (
        "aesthetic", "tech_sharpness", "color_score", "exposure_score",
        "comp_score", "contrast_score", "power_point_score", "face_quality",
        "eye_sharpness", "face_sharpness")}
    m.update(noise_sigma=float(rng.uniform(0, 8)),
             histogram_bimodality=float(rng.uniform(0, 4)),
             mean_saturation=float(rng.uniform(0, 1)),
             leading_lines_score=float(rng.uniform(0, 6)),
             mean_luminance=float(rng.uniform(0, 1)),
             shadow_clipped=int(rng.integers(0, 2)),
             highlight_clipped=int(rng.integers(0, 2)),
             is_silhouette=int(rng.integers(0, 2)),
             is_monochrome=int(rng.integers(0, 2)),
             is_blink=int(rng.integers(0, 2)),
             face_count=int(rng.integers(0, 5)),
             face_ratio=float(rng.uniform(0, 0.4)),
             is_group_portrait=0, isolation_bonus=float(rng.uniform(1, 2)),
             iso=int(rng.choice([100, 800, 3200, 12800])),
             f_stop=float(rng.choice([1.4, 2.0, 2.8, 8.0])),
             shutter_speed=str(rng.choice(["1/250", "1/30", "2"])),
             focal_length=float(rng.choice([24, 50, 200])),
             tags=str(rng.choice(["", "landscape, mountain", "portrait", "bird"])))
    return m


@pytest.fixture
def configs(tmp_path):
    """(facet_tpu ScoringConfig, facet_tpu_torch ScoringConfig) read from the
    same default config file."""
    from facet_tpu.config.default_config import write_default_config
    from facet_tpu.config.scoring_config import ScoringConfig as JConfig
    from facet_tpu_torch.config.scoring_config import ScoringConfig as TConfig

    path = str(tmp_path / "scoring_config.json")
    write_default_config(path)
    return JConfig(path), TConfig(path)


def test_schema_sql_identical(tmp_path):
    import sqlite3

    from facet_tpu.db.schema import init_database as jinit
    from facet_tpu_torch.db.schema import init_database as tinit

    sql = []
    for name, init in (("jax.db", jinit), ("torch.db", tinit)):
        path = str(tmp_path / name)
        init(path)
        conn = sqlite3.connect(path)
        sql.append(conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master"
                                " ORDER BY type, name").fetchall())
        conn.close()
    assert sql[0] == sql[1]
    assert any(row[1] == "photos" for row in sql[0])


def test_default_config_identical(configs):
    from facet_tpu.config.default_config import build_default_config as jbuild
    from facet_tpu_torch.config.default_config import build_default_config as tbuild

    assert jbuild() == tbuild()
    jcfg, tcfg = configs
    assert jcfg.config == tcfg.config
    assert jcfg.version_hash == tcfg.version_hash
    assert (jcfg.suggest_hardware_profile(80.0) == tcfg.suggest_hardware_profile(80.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brain_matches(configs, seed):
    from facet_tpu.scoring import brain as jbrain
    from facet_tpu_torch.scoring import brain as tbrain

    jcfg, tcfg = configs
    m = _metrics(seed)
    assert tbrain.calculate_aggregate(dict(m), tcfg) == \
        jbrain.calculate_aggregate(dict(m), jcfg)
    assert tbrain.determine_photo_category(m, tcfg) == \
        jbrain.determine_photo_category(m, jcfg)
    assert tbrain.scoring_penalties(m, tcfg) == jbrain.scoring_penalties(m, jcfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_composition_matches(configs, seed):
    from facet_tpu.analyzers.composition import CompositionAnalyzer as JComp
    from facet_tpu_torch.analyzers.composition import CompositionAnalyzer as TComp

    jcfg, tcfg = configs
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:90, 0:120]
    rgb = np.clip(rng.uniform(0, 255, 3) + 0.9 * xx[..., None] - 0.6 * yy[..., None]
                  + rng.normal(0, 25, (90, 120, 3)), 0, 255).astype(np.uint8)
    rgb[30:60, 70:100] = 255 - rgb[30:60, 70:100]       # a subject
    assert TComp(tcfg).analyze(rgb, None) == JComp(jcfg).analyze(rgb, None)
    assert TComp(tcfg).analyze(rgb, (10, 10, 40, 50)) == \
        JComp(jcfg).analyze(rgb, (10, 10, 40, 50))


def test_category_filter_matches(configs):
    from facet_tpu.config.category_filter import CategoryFilter as JFilter
    from facet_tpu_torch.config.category_filter import CategoryFilter as TFilter

    jcfg, tcfg = configs
    filters = [c.get("filters", {}) for c in jcfg.get_categories()]
    assert filters
    for seed in range(6):
        # the filters read the parsed shutter speed, in seconds
        m = {**_metrics(seed), "shutter_speed": (1 / 250, 1 / 30, 2.0)[seed % 3]}
        for f in filters:
            assert TFilter(f).matches(m) == JFilter(f).matches(m), (seed, f)
        assert tcfg.determine_category(m) == jcfg.determine_category(m)


def test_percentile_normalizer_matches(configs, tmp_path):
    from facet_tpu.config.percentile_normalizer import PercentileNormalizer as JNorm
    from facet_tpu.db.connection import get_connection
    from facet_tpu_torch.config.percentile_normalizer import PercentileNormalizer as TNorm
    from facet_tpu_torch.db.schema import init_database

    jcfg, tcfg = configs
    db = str(tmp_path / "lib.db")
    init_database(db)
    rng = np.random.default_rng(3)
    with get_connection(db) as conn:
        for i in range(80):
            conn.execute(
                "INSERT INTO photos (path, aggregate, aesthetic, exposure_score,"
                " tech_sharpness, color_score, comp_score, contrast_score,"
                " category, raw_sharpness_variance, raw_color_entropy,"
                " face_count, face_ratio) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, 0, 0.0)",
                (f"/lib/p{i:03d}.jpg", float(rng.uniform(2, 9)),
                 *(float(rng.uniform(0, 10)) for _ in range(6)),
                 "landscape" if i % 2 else "default",
                 float(rng.uniform(50, 3000)), float(rng.uniform(5, 15))))
    norms = []
    for cls, cfg in ((JNorm, jcfg), (TNorm, tcfg)):
        norm = cls(db, cfg)
        norms.append((norm.compute_percentiles(), norm))
        norm.compute_percentiles_per_category()
    (jp, jn), (tp, tn) = norms
    assert tp == jp and tn._by_category == jn._by_category
    for value in (10.0, 700.0, 5000.0):
        assert tn.normalize("raw_sharpness_variance", value, "landscape") == \
            jn.normalize("raw_sharpness_variance", value, "landscape")
    assert tn.analyze_scoring_issues() == jn.analyze_scoring_issues()


def test_thumbnail_and_tag_utils_match():
    from PIL import Image

    from facet_tpu.utils.tags import tags_to_string as jtags
    from facet_tpu.utils.thumbnails import make_thumbnail as jthumb
    from facet_tpu_torch.utils.tags import tags_to_string as ttags
    from facet_tpu_torch.utils.thumbnails import make_thumbnail as tthumb

    rgb = np.random.default_rng(5).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    pil = Image.fromarray(rgb)
    assert tthumb(pil, 64, 80) == jthumb(pil, 64, 80)
    assert Image.open(io.BytesIO(tthumb(pil, 64, 80))).size[0] <= 64
    for tags in ([], ["a"], ["landscape", "mountain", "sky"]):
        assert ttags(tags) == jtags(tags)


def _detections(rng, n):
    """n candidate rows of one image: scores descending from 0.95, boxes
    clustered so that NMS suppresses some, five keypoints each."""
    top = np.sort(rng.uniform(0.3, 0.95, n))[::-1].astype(np.float32)
    centers = rng.uniform(20, 100, (n, 2))[rng.integers(0, 4, n)]
    half = rng.uniform(8, 30, (n, 2))
    boxes = np.concatenate([centers - half, centers + half], 1).astype(np.float32)
    kps = (centers[:, None, :] + rng.normal(0, 5, (n, 5, 2))).astype(np.float32)
    return top, boxes, kps


def test_face_decode_helpers_match():
    """topk_to_detections, nms and umeyama_similarity: the port's numpy
    copies return what facet_tpu's do."""
    from facet_tpu.models import face_models as jfm
    from facet_tpu_torch.models import face_models as tfm

    rng = np.random.default_rng(7)
    top, boxes, kps = zip(*(_detections(rng, 24) for _ in range(3)))
    top, boxes, kps = np.stack(top), np.stack(boxes), np.stack(kps)
    want = jfm.topk_to_detections(top, boxes, kps, score_threshold=0.5)
    got = tfm.topk_to_detections(top, boxes, kps, score_threshold=0.5)
    assert [len(d) for d in got] == [len(d) for d in want] and sum(map(len, want)) > 3
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
        kept_g, kept_w = tfm.nms(g_img), jfm.nms(w_img)
        assert [d[0] for d in kept_g] == [d[0] for d in kept_w]
        assert 0 < len(kept_w) < len(w_img)
    for src in (rng.uniform(0, 200, (5, 2)), rng.uniform(0, 200, (5, 2)) * [-1, 1]):
        src = src.astype(np.float32)
        np.testing.assert_array_equal(tfm.umeyama_similarity(src, tfm.ARCFACE_DST),
                                      jfm.umeyama_similarity(src, jfm.ARCFACE_DST))


def test_samp_results_match():
    """SAMP-Net's raw heads -> score dicts: the 0-10 rescale, the dominant
    pattern and power_point_score."""
    from facet_tpu.models.samp_net import SAMPComposition
    from facet_tpu_torch.models.samp_net import to_results

    rng = np.random.default_rng(8)
    pw = rng.normal(0, 2, (4, 8)).astype(np.float32)
    attrs = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    dist = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    assert to_results(pw, attrs, dist) == SAMPComposition._to_results(None, pw, attrs, dist)


def test_face_aggregate_matches(configs, monkeypatch):
    """A photo's faces -> the photo-level face dict and the faces rows
    (quality, eye and face sharpness, blink, ratio, combined box, JPEG
    thumbnails): the port's host arithmetic against facet_tpu's."""
    monkeypatch.setenv("FACET_DISABLE_DP", "1")
    from facet_tpu.models import face_pipeline as jfp
    from facet_tpu_torch.models import face_pipeline as tfp
    from facet_tpu_torch.models.face_models import IResNet, LandmarkNet
    from facet_tpu_torch.models.scrfd import SCRFD

    jcfg, tcfg = configs
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:120, 0:160]
    image = np.clip(rng.uniform(0, 255, 3) + 0.7 * xx[..., None] - 0.4 * yy[..., None]
                    + rng.normal(0, 25, (120, 160, 3)), 0, 255).astype(np.uint8)
    faces = []
    for score, (x1, y1) in zip((0.93, 0.81, 0.77), ((10.4, 12.7), (70.2, 30.9), (-5.5, 80.1))):
        bbox = np.array([x1, y1, x1 + 46.3, y1 + 52.8], np.float32)
        lmk = (np.array([x1 + 23, y1 + 26]) + rng.normal(0, 9, (106, 2))).astype(np.float32)
        faces.append({"det": {"score": score, "bbox": bbox, "kps": lmk[:5]},
                      "embedding": rng.normal(0, 1, 512).astype(np.float32),
                      "landmarks": lmk})
    want_pipe = jfp.FacePipeline(None, None, None, config=jcfg)
    got_pipe = tfp.FacePipeline(SCRFD(), LandmarkNet(), IResNet(), "cpu", tcfg)
    want, got = want_pipe._aggregate(image, faces), got_pipe._aggregate(image, faces)
    assert got == want
    assert got["face_count"] == 3 and all(r["thumbnail"] for r in got["rows"])
    assert tfp.EMPTY_RESULT == jfp.EMPTY_RESULT
    assert tfp.average_ear(faces[0]["landmarks"]) == jfp.average_ear(faces[0]["landmarks"])
    np.testing.assert_array_equal(got_pipe._align_crop(image, faces[1]["det"]["kps"]),
                                  want_pipe._align_crop(image, faces[1]["det"]["kps"]))
    (g_crop, (g_center, g_size)) = got_pipe._landmark_crop(image, faces[2]["det"]["bbox"])
    (w_crop, (w_center, w_size)) = want_pipe._landmark_crop(image, faces[2]["det"]["bbox"])
    np.testing.assert_array_equal(g_crop, w_crop)
    np.testing.assert_array_equal(g_center, w_center)
    assert g_size == w_size
