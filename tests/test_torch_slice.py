"""The slice end to end: ``--pass quality`` through the port against the
JAX engine, on the same small JPEGs, into two databases; and ``--pass
embeddings`` of both under the ViT's other attention schedules
(FACET_ATTN_IMPL=psoftmax and =flash: kernels 6 and 7, their twins here,
against the Pallas kernels in interpret mode).

JAX side: ChunkedMultiPassProcessor(Facet(...)).run_single_pass(files,
"quality") with FACET_ENTROPY_IMPL=pallas and FACET_TOPIQ_ATTN=pallas (the
TPU's main-path kernels, run in interpret mode). A tiny CLIP comes through
the config's models.clip.architecture; TOPIQ at input 128 (whose C2 level,
1024 queries over 256 keys, passes the kernel gate) through
ModelManager.register with fallback_init(seed=30) parameters. The port runs
the same pass with its own numpy fallback parameters, in both of its stats
configurations: the default (kernels 1 and 5) and, with
FACET_ENTROPY_IMPL=pallas_fused, kernels 4 and 5 (their plain twins here).

Every ``photos`` column is compared: integer and bytes columns identical;
columns derived from the integer statistics within 1e-6; entropy-derived
columns within the entropy bound (atol=rtol=1e-5); topiq_score (stored
rounded to 0.01) within 1e-3; the CLIP embedding and the CLIP aesthetic,
which both packages compute in bf16 (the config has no knob for it),
within the bounds measured here and stated below; category identical.

The default multi-pass scan under the "16gb" profile (clip, topiq,
samp_net, insightface in one pass group: SCRFD's detection, TOPIQ and
SAMP-Net riding the fused pass), then ``--pass composition`` and ``--pass
faces``, run in both packages on the three photos of one shape, each into
a fresh database, with the members built through ``ModelManager.register``
from the same flax trees: SAMP-Net's and U2-Net-P's fallback init (seeds
20 and 21), and SCRFD (on a 160 px canvas), the landmark net and ArcFace
from theirs with random BatchNorm statistics and SCRFD's reg scales at 1
(tests/test_torch_faces.py says why). The trees come from the port's
``params.fallback_values``, which tests/test_torch_params.py holds bit for
bit to the JAX package's ``fallback_init``, so no flax init is traced
here. Besides the columns above: SAMP-Net's
comp_score and power_point_score (stored rounded to 0.01) within 1e-3 and
its pattern identical; face_count, is_blink and is_group_portrait
identical, the other face columns within 1e-3 (relative for the Laplacian
variances); the ``faces`` rows with identical boxes, indices and JPEG
thumbnails, confidence within 1e-5, the 512 embedding values within atol
1e-4 / rtol 1e-3 and the 106x2 landmarks within 1e-3 px. A photo with a
detection decision within DECISION_TOL of a threshold (the 0.5 and 0.7
score thresholds, the 64th score, the 30 px face size, the integer a box
corner is truncated to) in the port's own detection has its face columns
reported, not compared.
"""

import json
import os
import sqlite3

import numpy as np
import pytest

TINY_ARCH = {"image_size": 28, "patch_size": 14, "width": 32, "layers": 1,
             "heads": 2, "projection_dim": 768}
# bf16 bounds, about 4x what this slice measured on the CPU: embedding
# max |d| 5.1e-4, CLIP aesthetic (0-10 scale) max |d| 2.6e-3
EMBEDDING_BF16_TOL = 2e-3
AESTHETIC_BF16_TOL = 1e-2

FROM_INTEGER_STATS = ("tech_sharpness", "raw_sharpness_variance",
                      "histogram_spread", "mean_luminance", "histogram_bimodality",
                      "dynamic_range_stops", "noise_sigma", "contrast_score",
                      "mean_saturation", "exposure_score", "comp_score",
                      "power_point_score", "leading_lines_score",
                      "isolation_bonus")
FROM_ENTROPY = ("raw_color_entropy", "color_score")
SCORES = ("topiq_score", "quality_score", "aesthetic", "aggregate")
FACE_EXACT = ("face_count", "is_blink", "is_group_portrait")
FACE_FLOAT = ("face_quality", "eye_sharpness", "face_sharpness", "face_ratio",
              "face_confidence", "raw_eye_sharpness")
SAMP_SCORES = ("comp_score", "power_point_score")
DET_SIZE = 160
DECISION_TOL = 1e-4


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("slice")
    photo_dir = root / "photos"
    photo_dir.mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:72, 0:96]
    for i in range(3):
        img = (rng.uniform(0, 255, 3) + 0.8 * xx[..., None] - 0.5 * yy[..., None]
               + rng.normal(0, 20, (72, 96, 3)))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            photo_dir / f"wide_{i}.jpg", quality=90)
    for i in range(2):
        img = rng.integers(0, 256, (61, 45, 3), dtype=np.uint8)
        Image.fromarray(img).save(photo_dir / f"odd_{i}.jpg", quality=90)
    from facet_tpu.config.default_config import write_default_config

    cfg_path = root / "scoring_config.json"
    write_default_config(str(cfg_path))
    cfg = json.loads(cfg_path.read_text())
    cfg.setdefault("models", {}).setdefault("clip", {})["architecture"] = TINY_ARCH
    cfg_path.write_text(json.dumps(cfg))
    files = sorted(str(p) for p in photo_dir.iterdir())
    return root, files, str(cfg_path)


def _rows(db):
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    rows = [dict(r) for r in conn.execute("SELECT * FROM photos ORDER BY path")]
    conn.close()
    return rows


@pytest.fixture(scope="module")
def runs(photos):
    root, files, cfg_path = photos
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_ENTROPY_IMPL", "pallas")
    mp.setenv("FACET_TOPIQ_ATTN", "pallas")
    mp.setenv("FACET_DISABLE_DP", "1")
    mp.chdir(root)          # no pretrained_models/ here: fallback params
    try:
        from facet_tpu.config.scoring_config import ScoringConfig
        from facet_tpu.models.checkpoints import fallback_init, sds
        from facet_tpu.models.topiq import TOPIQConfig, TOPIQNet, TOPIQScorer
        from facet_tpu.processing.multi_pass import ChunkedMultiPassProcessor
        from facet_tpu.processing.scorer import Facet
        from facet_tpu_torch import params as P
        from facet_tpu_torch.models import topiq as ttopiq
        from facet_tpu_torch.processing.multi_pass import (
            ChunkedMultiPassProcessor as TProcessor)
        from facet_tpu_torch.processing.scorer import Facet as TFacet

        jcfg = TOPIQConfig(input_size=128)
        jfacet = Facet(str(root / "jax.db"), ScoringConfig(cfg_path))
        jfacet.models.register("topiq", lambda config, cached: TOPIQScorer(
            fallback_init(TOPIQNet(jcfg), sds((1, 128, 128, 3)), seed=30), jcfg))
        ChunkedMultiPassProcessor(jfacet).run_single_pass(files, "quality",
                                                          verbose=False)

        tfacet = TFacet(str(root / "torch.db"), ScoringConfig(cfg_path), device="cpu")
        tfacet.models.register("topiq", lambda config, cached: ttopiq.TOPIQScorer(
            P.fallback_init(ttopiq.TOPIQNet(ttopiq.TOPIQConfig(input_size=128)),
                            seed=30), "cpu"))
        TProcessor(tfacet).run_single_pass(files, "quality", verbose=False)
        yield jfacet, tfacet, _rows(str(root / "jax.db")), _rows(str(root / "torch.db"))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def fused_rows(runs, photos):
    """The port's rows with FACET_ENTROPY_IMPL=pallas_fused, read when the
    fused scorer is built, into a fresh database."""
    root, files, cfg_path = photos
    _, tfacet, _, _ = runs
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_ENTROPY_IMPL", "pallas_fused")
    mp.chdir(root)
    try:
        from facet_tpu_torch.config.scoring_config import ScoringConfig
        from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
        from facet_tpu_torch.processing.scorer import Facet

        facet = Facet(str(root / "torch_fused.db"), ScoringConfig(cfg_path),
                      model_manager=tfacet.models)
        ChunkedMultiPassProcessor(facet).run_single_pass(files, "quality", verbose=False)
        assert facet._fused.entropy_impl == "pallas_fused"
        return _rows(str(root / "torch_fused.db"))
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=["psoftmax", "flash"])
def embeddings_runs(request, photos):
    """``--pass embeddings`` of both packages with FACET_ATTN_IMPL set to
    the schedule under test, each into a fresh database."""
    impl = request.param
    root, files, cfg_path = photos
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_ATTN_IMPL", impl)
    mp.setenv("FACET_ENTROPY_IMPL", "pallas")
    mp.setenv("FACET_DISABLE_DP", "1")
    mp.chdir(root)
    try:
        from facet_tpu.config.scoring_config import ScoringConfig as JConfig
        from facet_tpu.processing.multi_pass import ChunkedMultiPassProcessor as JProcessor
        from facet_tpu.processing.scorer import Facet as JFacet
        from facet_tpu_torch.config.scoring_config import ScoringConfig
        from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
        from facet_tpu_torch.processing.scorer import Facet

        jdb, tdb = str(root / f"jax_{impl}.db"), str(root / f"torch_{impl}.db")
        JProcessor(JFacet(jdb, JConfig(cfg_path))).run_single_pass(
            files, "embeddings", verbose=False)
        facet = Facet(tdb, ScoringConfig(cfg_path), device="cpu")
        ChunkedMultiPassProcessor(facet).run_single_pass(files, "embeddings", verbose=False)
        assert facet._fused.attn_impl == impl
        return impl, _rows(jdb), _rows(tdb)
    finally:
        mp.undo()


def _assert_rows_match(got, want, scoring_model="topiq", samp=False, unsure=()):
    """``scoring_model`` "clip-mlp": the rows' aesthetic is the CLIP
    aesthetic, held at the bf16 bound. ``samp``: composition comes from
    SAMP-Net. ``unsure``: paths whose face columns (and the aggregate and
    category they feed) are not compared."""
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert set(got[0]) == set(want[0])
    for g, w in zip(got, want):
        assert g["scoring_model"] == scoring_model
        for col in w:
            if g["path"] in unsure and col in FACE_EXACT + FACE_FLOAT + (
                    "aggregate", "category"):
                continue
            if col in FACE_FLOAT and w[col] is not None:
                assert g[col] == pytest.approx(w[col], rel=1e-3, abs=1e-3), col
            elif samp and col in SAMP_SCORES:
                assert g[col] == pytest.approx(w[col], abs=1e-3), col
            elif col in FROM_INTEGER_STATS and w[col] is not None:
                assert g[col] == pytest.approx(w[col], abs=1e-6), col
            elif col in FROM_ENTROPY:
                assert g[col] == pytest.approx(w[col], abs=1e-5, rel=1e-5), col
            elif col == "aesthetic" and scoring_model == "clip-mlp":
                assert g[col] == pytest.approx(w[col], abs=AESTHETIC_BF16_TOL), col
            elif col in SCORES:
                assert g[col] == pytest.approx(w[col], abs=1e-3), col
            elif col == "clip_embedding" and w[col] is not None:
                diff = np.abs(np.frombuffer(g[col], np.float32)
                              - np.frombuffer(w[col], np.float32))
                assert diff.max() <= EMBEDDING_BF16_TOL
            else:
                assert g[col] == w[col], col


def test_every_row_and_column(runs, photos):
    """Every column: the named float groups at their bounds, the embedding
    at the bf16 bound, every other column (integers, bytes, text, flags,
    NULLs) identical."""
    _, files, _ = photos
    _, _, want, got = runs
    assert [r["path"] for r in want] == sorted(files)
    _assert_rows_match(got, want)
    assert got[0]["histogram_data"] and got[0]["phash"] and got[0]["thumbnail"]


@pytest.mark.parametrize("against", ["port_default", "facet_tpu"])
def test_pallas_fused_rows_match(runs, fused_rows, against):
    """The pallas_fused configuration writes the default configuration's
    rows, and facet_tpu's, at the same bounds."""
    _, _, jax_rows, torch_rows = runs
    _assert_rows_match(fused_rows, torch_rows if against == "port_default" else jax_rows)


def test_clip_aesthetic_bf16_bound(runs, photos):
    """The quality pass stores TOPIQ's score as the aesthetic; the CLIP
    aesthetic both engines computed in bf16 is compared on the fused
    scorers the two runs built."""
    from facet_tpu.utils.image_loading import load_image

    _, files, _ = photos
    jfacet, tfacet, _, _ = runs
    images = [np.asarray(load_image(f), np.uint8) for f in files]
    want = jfacet._fused_scorer().score_images(images)
    got = tfacet._fused_scorer().score_images(images)
    for g, w in zip(got, want):
        assert g[0] == pytest.approx(w[0], abs=AESTHETIC_BF16_TOL)
        assert g[2] == w[2]                       # pHash


def test_cli_quality_pass_and_refusals(photos, tmp_path, capsys, monkeypatch):
    """python -m facet_tpu_torch <dir> --pass embeddings writes every row;
    the default scan under ``vram_profile: auto`` on a card of 20 GB or more
    (the "24gb" profile, which tags with the unported VLM), --single-pass,
    --dry-run and other photos.py modes are refused with a non-zero exit
    that names what they need."""
    from facet_tpu_torch.__main__ import main
    from facet_tpu_torch.models import model_manager

    _, files, cfg_path = photos
    photo_dir = os.path.dirname(files[0])
    db = str(tmp_path / "cli.db")
    args = ["--db", db, "--config", cfg_path, "--device", "cpu"]
    assert main([photo_dir, "--pass", "embeddings", "--limit", "2"] + args) == 0
    assert len(_rows(db)) == 2
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.setattr(model_manager, "detect_device_memory_gb", lambda device: 80.0)
        assert main([photo_dir] + args) == 2
    err = capsys.readouterr().err
    assert "vlm_tagger" in err and "'24gb'" in err
    assert main([photo_dir, "--single-pass"] + args) == 2
    assert "BatchProcessor" in capsys.readouterr().err
    assert main([photo_dir, "--dry-run"] + args) == 2
    assert "score_paths" in capsys.readouterr().err
    assert main([photo_dir, "--recompute-average"] + args) == 2
    assert "not yet ported" in capsys.readouterr().err
    assert len(_rows(db)) == 2


@pytest.mark.parametrize("scan", [[], ["--pass", "faces"]], ids=["default", "faces"])
def test_cli_refuses_landmark_graph(photos, tmp_path, capsys, monkeypatch, scan):
    """With a converted 2d106det graph installed, a scan that holds the faces
    member exits 2 naming the graph before any row is written (the JAX
    package would run that graph; the port has no runner for it), instead
    of skipping the member and writing "no face" rows."""
    from facet_tpu_torch import params as P
    from facet_tpu_torch.__main__ import main

    _, files, cfg_path = photos
    cfg = json.loads(open(cfg_path).read())
    cfg["models"]["vram_profile"] = "16gb"
    cfg16 = tmp_path / "cfg16.json"
    cfg16.write_text(json.dumps(cfg))
    pretrained = tmp_path / "pretrained"
    pretrained.mkdir()
    (pretrained / "landmark_106_graph.npz").write_bytes(b"")
    monkeypatch.setattr(P, "PRETRAINED_DIR", str(pretrained))
    db = str(tmp_path / "graph.db")
    rc = main([os.path.dirname(files[0]), *scan, "--db", db, "--config", str(cfg16),
               "--device", "cpu"])
    assert rc == 2
    assert "landmark_106_graph" in capsys.readouterr().err
    assert _rows(db) == []


def test_embeddings_pass_attention_schedules(embeddings_runs):
    """Under FACET_ATTN_IMPL=psoftmax and =flash the port's --pass
    embeddings rows match facet_tpu's under the same variable: the CLIP
    aesthetic and embedding at the bf16 bounds above (measured at most
    2.5e-3 and 4.6e-4), every other column as in the quality pass."""
    _, want, got = embeddings_runs
    _assert_rows_match(got, want, scoring_model="clip-mlp")


# ------------------------------------------- the default scan (16gb profile)


def _member_trees():
    """{member: flax trees} for samp_net (SAMP-Net, U2-Net-P) and
    insightface (SCRFD at DET_SIZE with reg scales 1, landmarks, ArcFace)."""
    from test_torch_params import fallback_tree

    from facet_tpu_torch.models import face_models, samp_net, scrfd, u2netp

    det = fallback_tree(scrfd.SCRFD(scrfd.SCRFDConfig(input_size=DET_SIZE)), 10, 1)
    for level in range(3):
        det["params"]["head"][f"scale{level}"] = np.float32(1.0)
    return {"samp_net": (fallback_tree(samp_net.SAMPNet(), 20),
                         fallback_tree(u2netp.U2NETP(), 21)),
            "insightface": (det, fallback_tree(face_models.LandmarkNet(), 11, 2),
                            fallback_tree(face_models.IResNet(), 12, 3))}


def _faces_rows(db):
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    rows = [dict(r) for r in conn.execute(
        "SELECT photo_path, face_index, embedding, bbox_x1, bbox_y1, bbox_x2, bbox_y2,"
        " confidence, face_thumbnail, landmark_2d_106 FROM faces"
        " ORDER BY photo_path, face_index")]
    conn.close()
    return rows


def _unsure_photos(pipeline, files):
    """Photos with a face decision within DECISION_TOL of a threshold in the
    port's own detection -> {path: what is near}: a score near 0.5 or 0.7,
    the 64th and 65th scores near each other, or a box that can pass the
    filters with a side near 30 px or a corner near an integer (boxes are
    held to 1e-4 relative)."""
    import torch

    from facet_tpu_torch.utils.image_loading import load_image

    unsure = {}
    pipeline.top_k, pipeline._detect_programs = 65, {}
    try:
        for path in files:
            img = np.asarray(load_image(path), np.uint8)
            run, scale = pipeline._detect_program(*img.shape[:2])
            top, boxes, _ = (t.numpy()[0] for t in run(torch.from_numpy(img.copy()[None])))
            near = [f"score {s:.6f}" for s in top[:64]
                    if min(abs(s - 0.5), abs(s - 0.7)) <= DECISION_TOL]
            if top[63] >= 0.5 - DECISION_TOL and top[63] - top[64] <= DECISION_TOL:
                near.append(f"64th score {top[63]:.6f}, 65th {top[64]:.6f}")
            for s, box in zip(top[:64], boxes[:64] / scale):
                size = np.array([box[2] - box[0], box[3] - box[1]])
                tol = 1e-4 * np.abs(box).max() + 1e-3
                if s < 0.7 - DECISION_TOL or (size < 30 - tol).any():
                    continue
                if (np.abs(size - 30) <= tol).any() or (
                        np.abs(box - np.round(box)) <= tol).any():
                    near.append(f"box {np.round(box, 4).tolist()}")
            if near:
                unsure[path] = near
    finally:
        pipeline.top_k, pipeline._detect_programs = 64, {}
    return unsure


@pytest.fixture(scope="module")
def scans16(photos):
    """The default scan, --pass composition and --pass faces of both
    packages under the "16gb" profile -> {scan: (jax rows, jax faces rows,
    port rows, port faces rows)}, and the port's unsure photos."""
    root, files, cfg_path = photos
    cfg = json.loads(open(cfg_path).read())
    cfg["models"]["vram_profile"] = "16gb"
    cfg16 = str(root / "scoring_config_16gb.json")
    with open(cfg16, "w") as fh:
        json.dump(cfg, fh)
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_ENTROPY_IMPL", "pallas")
    mp.setenv("FACET_TOPIQ_ATTN", "pallas")
    mp.setenv("FACET_DISABLE_DP", "1")
    mp.chdir(root)          # no pretrained_models/ here: fallback params
    try:
        from facet_tpu.config.scoring_config import ScoringConfig as JConfig
        from facet_tpu.models.checkpoints import fallback_init, sds
        from facet_tpu.models.face_pipeline import FacePipeline as JFacePipeline
        from facet_tpu.models.samp_net import SAMPComposition as JSAMP
        from facet_tpu.models.scrfd import SCRFD_10G
        from facet_tpu.models.topiq import TOPIQConfig, TOPIQNet, TOPIQScorer
        from facet_tpu.processing.multi_pass import ChunkedMultiPassProcessor as JProcessor
        from facet_tpu.processing.scorer import Facet as JFacet
        from facet_tpu_torch import params as P
        from facet_tpu_torch.config.scoring_config import ScoringConfig
        from facet_tpu_torch.models import face_models, samp_net, scrfd, u2netp
        from facet_tpu_torch.models import topiq as ttopiq
        from facet_tpu_torch.models.face_pipeline import FacePipeline
        from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
        from facet_tpu_torch.processing.scorer import Facet

        from dataclasses import replace

        trees = _member_trees()
        faces, samp = trees["insightface"], trees["samp_net"]
        files = [f for f in files if os.path.basename(f).startswith("wide_")]
        jcfg = TOPIQConfig(input_size=128)
        jfacet = JFacet(str(root / "jax16_default.db"), JConfig(cfg16))
        jfacet.models.register("topiq", lambda config, cached: TOPIQScorer(
            fallback_init(TOPIQNet(jcfg), sds((1, 128, 128, 3)), seed=30), jcfg))
        jfacet.models.register("samp_net", lambda config, cached: JSAMP(*samp))
        jfacet.models.register("insightface", lambda config, cached: JFacePipeline(
            *faces, config=config, det_config=replace(SCRFD_10G, input_size=DET_SIZE)))
        tfacet = Facet(str(root / "torch16_default.db"), ScoringConfig(cfg16), device="cpu")
        tfacet.models.register("topiq", lambda config, cached: ttopiq.TOPIQScorer(
            P.fallback_init(ttopiq.TOPIQNet(ttopiq.TOPIQConfig(input_size=128)),
                            seed=30), "cpu"))
        tfacet.models.register("samp_net", lambda config, cached: samp_net.SAMPComposition(
            P.bridge(samp_net.SAMPNet(), samp[0]), P.bridge(u2netp.U2NETP(), samp[1]), "cpu"))
        tfacet.models.register("insightface", lambda config, cached: FacePipeline(
            P.bridge(scrfd.SCRFD(scrfd.SCRFDConfig(input_size=DET_SIZE)), faces[0]),
            P.bridge(face_models.LandmarkNet(), faces[1]),
            P.bridge(face_models.IResNet(), faces[2]), "cpu", config))

        JProcessor(jfacet).process_directory(files, verbose=False)
        ChunkedMultiPassProcessor(tfacet).process_directory(files, verbose=False)
        out = {}
        for scan in ("default", "composition", "faces"):
            jdb, tdb = str(root / f"jax16_{scan}.db"), str(root / f"torch16_{scan}.db")
            if scan != "default":
                JProcessor(JFacet(jdb, JConfig(cfg16), model_manager=jfacet.models)
                           ).run_single_pass(files, scan, verbose=False)
                ChunkedMultiPassProcessor(Facet(tdb, ScoringConfig(cfg16),
                                                model_manager=tfacet.models)
                                          ).run_single_pass(files, scan, verbose=False)
            out[scan] = (_rows(jdb), _faces_rows(jdb), _rows(tdb), _faces_rows(tdb))
        unsure = _unsure_photos(tfacet.models.load_model("insightface"), files)
        yield out, unsure
    finally:
        mp.undo()


def _assert_faces_match(got, want, unsure):
    got = [r for r in got if r["photo_path"] not in unsure]
    want = [r for r in want if r["photo_path"] not in unsure]
    assert [(r["photo_path"], r["face_index"]) for r in got] == [
        (r["photo_path"], r["face_index"]) for r in want]
    for g, w in zip(got, want):
        for col in ("bbox_x1", "bbox_y1", "bbox_x2", "bbox_y2", "face_thumbnail"):
            assert g[col] == w[col], col
        assert g["confidence"] == pytest.approx(w["confidence"], abs=1e-5)
        emb = np.frombuffer(g["embedding"], np.float32)
        assert emb.shape == (512,)
        np.testing.assert_allclose(emb, np.frombuffer(w["embedding"], np.float32),
                                   atol=1e-4, rtol=1e-3)
        lmk = np.frombuffer(g["landmark_2d_106"], np.float32)
        assert lmk.shape == (212,)
        np.testing.assert_allclose(lmk, np.frombuffer(w["landmark_2d_106"], np.float32),
                                   atol=1e-3)
        assert g["face_thumbnail"][:2] == b"\xff\xd8"      # a JPEG


@pytest.mark.parametrize("scan", ["default", "composition", "faces"])
def test_default_scan_16gb_rows_and_faces(scans16, scan):
    """The default scan and the composition and faces passes write facet_tpu's
    rows and faces rows. The default scan fills every member's columns:
    TOPIQ's score, SAMP-Net's composition (not the rule-based analyzer's),
    the face columns and the faces table."""
    out, unsure = scans16
    want, want_faces, got, got_faces = out[scan]
    if unsure:
        print(f"face decisions within {DECISION_TOL} of a threshold, face columns not "
              f"compared: {unsure}")
    _assert_rows_match(got, want, scoring_model="topiq" if scan == "default" else None,
                       samp=scan != "faces", unsure=set(unsure))
    _assert_faces_match(got_faces, want_faces, unsure)
    if scan != "faces":
        assert all(r["composition_pattern"] is not None and r["leading_lines_score"] is None
                   for r in got)
    if scan != "composition":
        assert got_faces and sum(r["face_count"] for r in got) == len(got_faces)
        assert len({r["photo_path"] for r in got_faces} - set(unsure)) > 0
    if scan == "default":
        assert all(r[c] is not None for r in got for c in (
            "topiq_score", "comp_score", "clip_embedding", "phash", "aggregate"))
