"""The port's models against the JAX package's, on the CPU.

Parameters come from the JAX package (fallback_init) and are bridged onto
the torch modules, so both sides compute with the same numbers; inputs are
numpy arrays made from a seed. Tolerances: CLIP features 1e-4 and the
aesthetic head 1e-5 at float32 on both sides (measured: CLIP 9.5e-7);
TOPIQ's raw sigmoid 1e-4 against both JAX attention paths (measured 6.2e-6
against xla, 1.8e-7 against the Pallas kernel); tag lists identical; aggregate scores
1e-5 with identical categories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_tpu_torch import params as P

TINY_CLIP = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4,
                 projection_dim=768)


def _tree(module, shape, seed):
    from facet_tpu.models.checkpoints import fallback_init, sds

    return jax.tree.map(np.asarray, fallback_init(module, sds(shape), seed=seed))


def _perturbed(tree, seed, scale=0.05):
    """The fallback init leaves biases and LayerNorm offsets at zero; add
    noise everywhere so the bridge of every leaf matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.normal(0, scale, a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def clip_pair():
    from facet_tpu.models import clip as jclip
    from facet_tpu_torch.models import clip

    jmod = jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**TINY_CLIP), dtype=jnp.float32)
    tree = _perturbed(_tree(jmod, (1, 56, 56, 3), 0), 1)
    tmod = clip.CLIPVisionTower(clip.CLIPVisionConfig(**TINY_CLIP), dtype=torch.float32)
    P.bridge(tmod, tree)
    return jmod, tree, tmod.eval()


def test_clip_tower_features(clip_pair):
    jmod, tree, tmod = clip_pair
    x = np.random.default_rng(2).normal(size=(3, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_clip_tower_bf16_casting_points(clip_pair):
    """bf16 compute on both sides, same casting points. Bound: 2% of the
    features' largest magnitude (measured 0.58%: bf16 rounds after every
    matmul, and the two frameworks' CPU bf16 kernels round at different
    points inside them)."""
    from facet_tpu.models import clip as jclip
    from facet_tpu_torch.models import clip

    _, tree, _ = clip_pair
    jmod = jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**TINY_CLIP))
    tmod = P.bridge(clip.CLIPVisionTower(clip.CLIPVisionConfig(**TINY_CLIP)), tree)
    x = np.random.default_rng(3).normal(size=(2, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 0.02 * scale


def test_aesthetic_head_and_recompute():
    from facet_tpu.models.aesthetic import AestheticHead as JHead
    from facet_tpu.models.aesthetic import AestheticScorer as JScorer
    from facet_tpu.models.clip import CLIPVisionConfig as JConfig
    from facet_tpu_torch.models import aesthetic, clip

    head_tree = _perturbed(_tree(JHead(), (1, 768), 1), 4)
    emb = np.random.default_rng(5).normal(size=(6, 768)).astype(np.float32)
    want_raw = np.asarray(JHead().apply(head_tree, jnp.asarray(emb)))
    head = P.bridge(aesthetic.AestheticHead(), head_tree)
    with torch.no_grad():
        got_raw = head(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got_raw, want_raw, atol=1e-5, rtol=1e-5)

    vision = clip.CLIPVisionTower(clip.CLIPVisionConfig(**TINY_CLIP))
    scorer = aesthetic.AestheticScorer(vision, head, "cpu")
    jscorer = JScorer(vision_params={}, head_params=head_tree,
                      config=JConfig(**TINY_CLIP))
    np.testing.assert_allclose(scorer.score_from_embeddings_batch(emb),
                               jscorer.score_from_embeddings_batch(emb),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def topiq_pair():
    from facet_tpu.models import topiq as jtopiq
    from facet_tpu_torch.models import topiq

    jnet = jtopiq.TOPIQNet(jtopiq.TOPIQConfig(input_size=128))
    tree = _tree(jnet, (1, 128, 128, 3), 30)
    tree = dict(tree, params=_perturbed(tree["params"], 6, scale=0.02))
    tnet = P.bridge(topiq.TOPIQNet(topiq.TOPIQConfig(input_size=128)), tree).eval()
    x = np.random.default_rng(7).normal(size=(2, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    return jnet, tree, x, got


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_topiq_raw_sigmoid(topiq_pair, impl, monkeypatch):
    """C2 at input 128 is 1024 queries over 256 keys: the gate admits it,
    so the port runs kernel 2's twin there and plain f32 elsewhere."""
    from facet_tpu_torch.ops import attention

    jnet, tree, x, got = topiq_pair
    assert attention.supported_shape(1024, 256)
    monkeypatch.setenv("FACET_TOPIQ_ATTN", impl)
    want = np.asarray(jax.jit(jnet.apply)(tree, jnp.asarray(x)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_topiq_forward_runs_full_float32(topiq_pair):
    """TOPIQ owns its precision: whatever TF32 settings the process holds,
    its forward runs with TF32 off for cuDNN and matmuls, and the caller's
    settings come back afterwards."""
    from facet_tpu_torch.models.topiq import TOPIQConfig, TOPIQNet, TOPIQScorer

    net = P.bridge(TOPIQNet(TOPIQConfig(input_size=128)), topiq_pair[1])
    scorer = TOPIQScorer(net, "cpu")
    seen = []
    hook = net.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        batch = torch.from_numpy(
            np.random.default_rng(3).integers(0, 256, (1, 40, 48, 3), dtype=np.uint8))
        raw = scorer.forward_u8(batch)
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest")]
    assert after == (True, "high")
    assert raw.shape == (1,) and torch.isfinite(raw).all()


def test_fused_pipeline_matches_jax(clip_pair):
    """The port's FusedScorer against the JAX FusedScorer (one device, f32
    CLIP): statistics exact, entropy 1e-5, pHash identical, aesthetic and
    embedding 1e-4."""
    from facet_tpu.models.aesthetic import AestheticHead as JHead
    from facet_tpu.processing.device_pipeline import FusedScorer as JFused
    from facet_tpu_torch.models.aesthetic import AestheticHead, AestheticScorer
    from facet_tpu_torch.processing.device_pipeline import FusedScorer

    jmod, tree, tmod = clip_pair
    head_tree = _perturbed(_tree(JHead(), (1, 768), 1), 8)
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(3)]
    images.insert(1, rng.integers(0, 256, (37, 53, 3), dtype=np.uint8))
    want = JFused(jmod, JHead(), tree, head_tree, mesh=None).score_images(images)
    scorer = AestheticScorer(tmod, P.bridge(AestheticHead(), head_tree), "cpu")
    got = FusedScorer(scorer).score_images(images)
    for (a, ea, ha, sa), (b, eb, hb, sb) in zip(got, want):
        assert a == pytest.approx(b, abs=1e-4)
        np.testing.assert_allclose(np.frombuffer(ea, np.float32),
                                   np.frombuffer(eb, np.float32), atol=1e-4)
        assert ha == hb
        np.testing.assert_array_equal(sa.gray_hist, sb.gray_hist)
        assert (sa.sat_sum, sa.lap_sum, sa.lap_sumsq, sa.imm_abs_sum) == \
            (sb.sat_sum, sb.lap_sum, sb.lap_sumsq, sb.imm_abs_sum)
        assert sa.hs_entropy == pytest.approx(sb.hs_entropy, abs=1e-5, rel=1e-5)


def test_clip_tagger_tag_lists(scoring_config):
    from facet_tpu.models.tagger import CLIPTagger as JTagger
    from facet_tpu_torch.models.tagger import CLIPTagger

    jt, tt = JTagger(scoring_config), CLIPTagger(scoring_config)
    np.testing.assert_array_equal(tt.prompt_matrix, jt.prompt_matrix)
    # embeddings near prompt directions, so tags clear the threshold
    rng = np.random.default_rng(10)
    picks = rng.choice(jt.prompt_matrix.shape[1], 12, replace=False)
    emb = jt.prompt_matrix[:, picks].T + rng.normal(0, 0.03, (12, 768))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    want, got = jt.tag_embeddings(emb), tt.tag_embeddings(emb)
    assert any(want)
    assert [[t for t, _ in row] for row in got] == [[t for t, _ in row] for row in want]
    for rg, rw in zip(got, want):
        np.testing.assert_allclose([s for _, s in rg], [s for _, s in rw], atol=1e-6)
    blobs = [e.tobytes() for e in emb]
    assert tt.tag_embedding_bytes(blobs) == tt.tag_embeddings(emb)


def test_aggregate_scorer(scoring_config):
    from facet_tpu.scoring.vectorized import AggregateScorer as JAgg
    from facet_tpu_torch.scoring.vectorized import AggregateScorer

    rng = np.random.default_rng(11)
    tags = ["", "landscape, mountain", "portrait", "night, city", "food", "concert"]
    rows = []
    for i in range(60):
        rows.append({
            "aesthetic": float(rng.uniform(0, 10)), "tech_sharpness": float(rng.uniform(0, 10)),
            "comp_score": float(rng.uniform(0, 10)), "exposure_score": float(rng.uniform(0, 10)),
            "color_score": float(rng.uniform(0, 10)), "contrast_score": float(rng.uniform(0, 10)),
            "mean_saturation": float(rng.uniform(0, 1)), "noise_sigma": float(rng.uniform(0, 12)),
            "histogram_bimodality": float(rng.uniform(-2, 5)),
            "histogram_spread": float(rng.uniform(0, 80)),
            "leading_lines_score": float(rng.uniform(0, 6)),
            "power_point_score": float(rng.uniform(0, 10)),
            "face_count": int(rng.integers(0, 6)), "face_quality": float(rng.uniform(0, 10)),
            "eye_sharpness": float(rng.uniform(0, 10)), "face_sharpness": float(rng.uniform(0, 10)),
            "face_ratio": float(rng.uniform(0, 0.5)), "is_blink": int(rng.integers(0, 2)),
            "iso": [None, 100, 3200, "6400"][i % 4], "f_stop": [None, 1.8, 2.8, "4"][i % 4],
            "isolation_bonus": float(rng.uniform(1, 2)), "is_silhouette": i % 7 == 0,
            "shadow_clipped": i % 3 == 0, "highlight_clipped": i % 5 == 0,
            "is_monochrome": i % 11 == 0, "tags": tags[i % len(tags)],
            "mean_luminance": float(rng.uniform(0, 1)),
        })
    want_scores, want_cats = JAgg(scoring_config).score_rows(rows)
    got_scores, got_cats = AggregateScorer(scoring_config).score_rows(rows)
    assert got_cats == want_cats
    assert len(set(got_cats)) > 2
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=1e-5, rtol=0)
    np.testing.assert_allclose(AggregateScorer(scoring_config).metric_values(rows),
                               JAgg(scoring_config).metric_values(rows), atol=1e-5)
