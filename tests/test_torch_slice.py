"""The slice end to end: ``--pass quality`` through the port against the
JAX engine, on the same small JPEGs, into two databases.

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


def _assert_rows_match(got, want):
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert set(got[0]) == set(want[0])
    for g, w in zip(got, want):
        assert g["scoring_model"] == "topiq"
        for col in w:
            if col in FROM_INTEGER_STATS and w[col] is not None:
                assert g[col] == pytest.approx(w[col], abs=1e-6), col
            elif col in FROM_ENTROPY:
                assert g[col] == pytest.approx(w[col], abs=1e-5, rel=1e-5), col
            elif col in SCORES:
                assert g[col] == pytest.approx(w[col], abs=1e-3), col
            elif col == "clip_embedding":
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


def test_cli_quality_pass_and_refusals(photos, tmp_path, capsys):
    """python -m facet_tpu_torch <dir> --pass quality writes every row; the
    default scan, --single-pass, unported passes and other photos.py modes
    are refused with a non-zero exit."""
    from facet_tpu_torch.__main__ import main

    _, files, cfg_path = photos
    photo_dir = os.path.dirname(files[0])
    db = str(tmp_path / "cli.db")
    args = ["--db", db, "--config", cfg_path, "--device", "cpu"]
    assert main([photo_dir, "--pass", "embeddings", "--limit", "2"] + args) == 0
    assert len(_rows(db)) == 2
    assert main([photo_dir] + args) == 2
    assert "insightface" in capsys.readouterr().err
    assert main([photo_dir, "--single-pass"] + args) == 2
    assert main([photo_dir, "--pass", "faces"] + args) == 2
    assert main([photo_dir, "--recompute-average"] + args) == 2
    assert "not yet ported" in capsys.readouterr().err
