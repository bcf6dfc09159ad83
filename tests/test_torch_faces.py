"""The faces member of the port against the JAX package.

SCRFD det_10g (on a 160 px canvas), the landmark net, ArcFace and the
``FacePipeline`` of ``facet_tpu_torch`` take the same seeded numpy inputs
and the same parameters as their ``facet_tpu`` counterparts: the fallback
trees with their BatchNorm statistics and biases drawn at random
(tests/test_torch_params.py:fallback_tree), bridged onto the torch
modules.

SCRFD's three per-stride reg scales are set to REG_SCALE, the ones that
``SCRFD.init`` gives them, on both sides. The fallback init fills them
with zeros (only leaves named exactly ``scale`` get ones, and these are
``scale0``..``scale2``), so with the fallback parameters every box has
zero size and no face passes the 30 px ``min_face_size``; with REG_SCALE
some random boxes have face sizes, so that crops, landmarks, embeddings
and the per-face statistics run.

Tolerances, each against the JAX function on the same inputs (measured
on this suite's CPU in brackets):

- SCRFD's raw heads on tests/test_scrfd.py's tiny configuration at 64 px:
  cls within atol 2e-5 / rtol 1e-4, reg and kps within 2e-4 / 1e-3, that
  file's bounds. On det_10g at 160 px the two float32 networks each stand
  3-3.5e-5 (cls) and 1.4-1.7e-4 (reg) from a float64 evaluation of the
  same network, which leaves the tiny bounds no room; there the port is
  held to JAX within atol 1e-4 / rtol 1e-4 (cls) and 5e-4 / 1e-3 (reg,
  kps), measured 4.9e-5 and 2.1e-4, and its own distance from float64
  must stay within 1.5x JAX's (measured 0.87-1.17x);
- ``decode_topk`` on the same raw heads: scores, their order and the boxes
  identical, also where scores tie; keypoints within 1e-4;
- ArcFace embeddings within atol 1e-4 / rtol 1e-3 (1.7e-6); landmarks
  within 1e-3 px (1.5e-5);
- detection from uint8 photos: every candidate decision whose score lies
  farther than DECISION_TOL from the 0.5 candidate threshold, the 0.7
  photo threshold and the k-th score is the same (scores within 2.7e-6),
  with boxes and keypoints within 1e-4 relative and 1e-3 px (1.9e-5
  relative); the decisions nearer than that are counted and reported, not
  compared;
- ``analyze_batch`` on the same detections: face counts, integer boxes,
  confidences, blink flags and JPEG thumbnails identical, embeddings and
  landmarks within the bounds above, the per-photo statistics within
  1e-3 (relative for the Laplacian variances; all identical here).
"""

import numpy as np
import pytest
import torch

DET_SIZE = 160
REG_SCALE = 1.0
DECISION_TOL = 1e-4
CLS_TOL = dict(atol=2e-5, rtol=1e-4)
REG_TOL = dict(atol=2e-4, rtol=1e-3)
EMBED_TOL = dict(atol=1e-4, rtol=1e-3)
LANDMARK_TOL = 1e-3


def det_config():
    from dataclasses import replace

    from facet_tpu.models.scrfd import SCRFD_10G

    return replace(SCRFD_10G, input_size=DET_SIZE)


@pytest.fixture(scope="module")
def trees():
    """(SCRFD, landmark net, ArcFace) flax trees at the create() seeds,
    perturbed."""
    from test_torch_params import fallback_tree

    from facet_tpu_torch.models import face_models, scrfd

    det = fallback_tree(scrfd.SCRFD(scrfd.SCRFDConfig(input_size=DET_SIZE)), 10, 1)
    for level in range(3):
        det["params"]["head"][f"scale{level}"] = np.float32(REG_SCALE)
    return (det, fallback_tree(face_models.LandmarkNet(), 11, 2),
            fallback_tree(face_models.IResNet(), 12, 3))


@pytest.fixture(scope="module")
def pipelines(trees):
    """(facet_tpu FacePipeline, facet_tpu_torch FacePipeline) on the same
    trees, with no device mesh on the JAX side."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_DISABLE_DP", "1")
    try:
        from facet_tpu.models.face_pipeline import FacePipeline as JFacePipeline
        from facet_tpu_torch import params as P
        from facet_tpu_torch.models import face_models, scrfd
        from facet_tpu_torch.models.face_pipeline import FacePipeline

        cfg = det_config()
        jfp = JFacePipeline(*trees, config=None, det_config=cfg)
        tcfg = scrfd.SCRFDConfig(input_size=DET_SIZE)
        tfp = FacePipeline(P.bridge(scrfd.SCRFD(tcfg), trees[0]),
                           P.bridge(face_models.LandmarkNet(), trees[1]),
                           P.bridge(face_models.IResNet(), trees[2]), "cpu")
        yield jfp, tfp
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def photos():
    """Four 96x128 photos (gradient plus noise) and one of an odd shape."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:128]
    images = []
    for _ in range(4):
        img = (rng.uniform(0, 255, 3) + 0.8 * xx[..., None] - 0.5 * yy[..., None]
               + rng.normal(0, 20, (96, 128, 3)))
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    images.append(rng.integers(0, 256, (75, 61, 3), dtype=np.uint8))
    return images


@pytest.mark.parametrize("config", ["tiny", "det_10g"])
def test_scrfd_raw_heads(trees, pipelines, config):
    import jax
    from test_scrfd import tiny_config
    from test_torch_params import fallback_tree

    from facet_tpu.models.scrfd import SCRFD
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models import scrfd

    if config == "tiny":
        jcfg = tiny_config()
        tcfg = scrfd.SCRFDConfig(**{k: getattr(jcfg, k) for k in (
            "stem_channels", "base_channels", "stage_blocks", "stage_planes",
            "neck_channels", "feat_channels", "stacked_convs", "input_size")})
        tree = fallback_tree(scrfd.SCRFD(tcfg), 10, 4)
        net = P.bridge(scrfd.SCRFD(tcfg), tree).eval()
        tols = (CLS_TOL, REG_TOL, REG_TOL)
    else:
        jcfg, tree, net = det_config(), trees[0], pipelines[1].detector
        tols = (dict(atol=1e-4, rtol=1e-4), dict(atol=5e-4, rtol=1e-3),
                dict(atol=5e-4, rtol=1e-3))
    size = jcfg.input_size
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    want = jax.jit(SCRFD(jcfg).apply)(tree, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for level, (g, w) in enumerate(zip(got, want)):
        for name, gt, wt, tol in zip(("cls", "reg", "kps"), g, w, tols):
            assert tuple(gt.shape) == wt.shape, (level, name)
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt), err_msg=f"{level} {name}",
                                       **tol)
    if config == "det_10g":
        import copy

        with torch.no_grad():
            exact = copy.deepcopy(net).double()(torch.from_numpy(x).double())
        for k, name in enumerate(("cls", "reg", "kps")):
            port = max(float((g[k].double() - e[k]).abs().max()) for g, e in zip(got, exact))
            ref = max(float(np.abs(np.asarray(w[k], np.float64) - e[k].numpy()).max())
                      for w, e in zip(want, exact))
            assert port <= 1.5 * ref, (name, port, ref)


def test_decode_topk(trees):
    """The same raw heads through both decodes, with ties planted among the
    best scores: jax.lax.top_k keeps tied scores in anchor order, and so
    does the port's stable sort."""
    import jax.numpy as jnp

    from facet_tpu.models.scrfd import decode_topk as jdecode
    from facet_tpu_torch.models.scrfd import decode_topk

    rng = np.random.default_rng(2)
    heads = []
    for size in (20, 10, 5):
        cls = rng.uniform(0, 1, (2, size, size, 2)).astype(np.float32)
        heads.append([cls, rng.standard_normal((2, size, size, 2, 4)).astype(np.float32),
                      rng.standard_normal((2, size, size, 2, 10)).astype(np.float32)])
    heads[0][0][:, 3:6, :, :] = 0.99          # 80 tied anchors above every other score
    heads[2][0][0, 1, 1, :] = 0.99
    want = [np.asarray(t) for t in jdecode([[jnp.asarray(a) for a in h] for h in heads])]
    got = [t.numpy() for t in decode_topk([[torch.from_numpy(a) for a in h] for h in heads])]
    # the 64 best of the 80 tied anchors: the same ones, in the same order
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)


def test_arcface_and_landmarks(trees, pipelines):
    import jax

    from facet_tpu.models.face_models import IResNet, LandmarkNet

    rng = np.random.default_rng(3)
    crops = rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jax.jit(IResNet().apply)(trees[2], crops))
    got = pipelines[1]._embed(crops)
    np.testing.assert_allclose(got, want, **EMBED_TOL)

    lmk_crops = rng.integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(LandmarkNet().apply)(
        trees[1], (lmk_crops.astype(np.float32) - 127.5) / 127.5))
    got = pipelines[1]._run_landmarks(lmk_crops)
    assert got.shape == (2, 106, 2)
    np.testing.assert_allclose(got, want, atol=LANDMARK_TOL)


@pytest.fixture(scope="module")
def detections(pipelines, photos):
    jfp, tfp = pipelines
    return jfp.detect_batch(photos), tfp.detect_batch(photos)


def _near(score, kth):
    return any(abs(score - t) <= DECISION_TOL for t in (0.5, 0.7, kth))


def test_detect_batch_decisions(pipelines, photos, detections):
    """Every detection decision away from a threshold is the same in both
    packages; the decisions within DECISION_TOL of one are reported."""
    jfp, tfp = pipelines
    want, got = detections
    near = 0
    for i, (w, g) in enumerate(zip(want, got)):
        run, scale = tfp._detect_program(*photos[i].shape[:2])
        top = run(torch.from_numpy(photos[i][None]))[0].numpy()[0]
        kth = float(top[-1])
        near += sum(_near(s, kth) for s in top)
        kept_w = [d for d in w if not _near(d["score"], kth)]
        kept_g = [d for d in g if not _near(d["score"], kth)]
        assert len(kept_g) == len(kept_w), i
        for dg, dw in zip(kept_g, kept_w):
            assert dg["score"] == pytest.approx(dw["score"], abs=CLS_TOL["atol"])
            np.testing.assert_allclose(dg["bbox"], dw["bbox"], rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(dg["kps"], dw["kps"], rtol=1e-4, atol=1e-3)
    print(f"detection decisions within {DECISION_TOL} of a threshold (not compared): {near}")
    faces = [d for dets in want for d in dets
             if d["score"] >= 0.7 and min(d["bbox"][2] - d["bbox"][0],
                                          d["bbox"][3] - d["bbox"][1]) >= 30]
    assert faces, "no face passes the photo filters"


def test_analyze_batch(pipelines, photos, detections):
    """Both pipelines from the same detections (the JAX package's): the
    crops, landmarks, embeddings, per-face rows and photo aggregates."""
    jfp, tfp = pipelines
    dets = detections[0]
    want = jfp.analyze_batch(photos, detections=dets)
    got = tfp.analyze_batch(photos, detections=dets)
    assert sum(r["face_count"] for r in want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("face_count", "is_blink", "combined_bbox"):
            assert g[key] == w[key], key
        for key in ("face_quality", "eye_sharpness", "face_ratio", "confidence"):
            assert g[key] == pytest.approx(w[key], abs=1e-3), key
        for key in ("raw_eye_sharpness", "face_sharpness"):
            assert g[key] == pytest.approx(w[key], rel=1e-3, abs=1e-3), key
        assert len(g["rows"]) == len(w["rows"])
        for rg, rw in zip(g["rows"], w["rows"]):
            for key in ("face_index", "bbox", "confidence", "thumbnail"):
                assert rg[key] == rw[key], key
            np.testing.assert_allclose(np.frombuffer(rg["embedding"], np.float32),
                                       np.frombuffer(rw["embedding"], np.float32),
                                       **EMBED_TOL)
            lg = np.frombuffer(rg["landmarks"], np.float32)
            assert lg.shape == (212,)
            np.testing.assert_allclose(lg, np.frombuffer(rw["landmarks"], np.float32),
                                       atol=LANDMARK_TOL)


def test_landmark_graph_refuses(tmp_path, monkeypatch):
    """A converted 2d106det graph makes the faces member raise: the port
    has no runner for it and does not stand LandmarkNet in."""
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models.face_pipeline import FacePipeline

    monkeypatch.setattr(P, "PRETRAINED_DIR", str(tmp_path))
    (tmp_path / "landmark_106_graph.npz").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="landmark_106_graph"):
        FacePipeline.create(None, None, "cpu")


@pytest.mark.parametrize("stage", ["detect", "landmarks", "embed"])
def test_face_forwards_run_full_float32(pipelines, photos, stage):
    """SCRFD, the landmark net and ArcFace own their precision, as the JAX
    package computes them in float32: whatever TF32 settings the process
    holds, each forward runs with TF32 off for cuDNN and matmuls, and the
    caller's settings come back afterwards."""
    tfp = pipelines[1]
    net, call = {
        "detect": (tfp.detector, lambda: tfp._detect_program(*photos[0].shape[:2])[0](
            torch.from_numpy(photos[0][None].copy()))),
        "landmarks": (tfp.landmark_net,
                      lambda: tfp._run_landmarks(np.zeros((1, 192, 192, 3), np.uint8))),
        "embed": (tfp.embedder, lambda: tfp._embed(np.zeros((1, 112, 112, 3), np.float32))),
    }[stage]
    seen = []
    hook = net.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())))
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        call()
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert seen == [(False, "highest")]
    assert after == (True, "high")
