"""The port's ops (facet_tpu_torch.ops) against facet_tpu.ops on the CPU.

Same numpy inputs through both packages: colour conversions exact over the
whole RGB cube, statistics exact (integer outputs) with the entropy within
1e-5 of the exact value, pHash bits identical away from median ties, resize matrices
identical and the separable resize within 1e-4 on the 0-255 scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _rgb_cube():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    return np.stack([r, g, b], axis=-1).reshape(4096, 4096, 3)


def test_rgb_to_gray_full_cube():
    from facet_tpu.ops import colorspace as jcs
    from facet_tpu_torch.ops import colorspace

    cube = _rgb_cube()
    want = np.asarray(jcs.rgb_to_gray(jnp.asarray(cube)))
    got = colorspace.rgb_to_gray(torch.from_numpy(cube)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rgb_to_hsv_full_cube():
    from facet_tpu.ops import colorspace as jcs
    from facet_tpu_torch.ops import colorspace

    cube = _rgb_cube()
    want = [np.asarray(t) for t in jcs.rgb_to_hsv(jnp.asarray(cube))]
    got = [t.numpy() for t in colorspace.rgb_to_hsv(torch.from_numpy(cube))]
    for name, a, b in zip("hsv", got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # every triple lands in the 180 x 256 H-S histogram: the one-pass
    # kernel (csrc/fused_stats.cu) counts an image's pixels as its in-range
    # count
    assert got[0].min() >= 0 and got[0].max() < 180
    assert got[1].min() >= 0 and got[1].max() < 256


def test_reciprocal_tables_match_cv2_formula():
    from facet_tpu.ops.colorspace import _HDIV_TABLE, _SDIV_TABLE
    from facet_tpu_torch.ops.colorspace import HDIV_TABLE, SDIV_TABLE

    np.testing.assert_array_equal(SDIV_TABLE, _SDIV_TABLE)
    np.testing.assert_array_equal(HDIV_TABLE, _HDIV_TABLE)


def _photo_like(b, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(0, 255, (b, 1, 1, 3))
    img = base + 0.5 * xx[None, ..., None] - 0.3 * yy[None, ..., None] \
        + rng.normal(0, 25, (b, h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _entropy_f64(rgb, stride):
    """Exact H-S entropy per image from a numpy histogram, in float64."""
    from facet_tpu_torch.ops.colorspace import rgb_to_hsv

    hh, ss, _ = rgb_to_hsv(torch.from_numpy(rgb))
    out = []
    for h_img, s_img in zip(hh.numpy(), ss.numpy()):
        codes = (h_img.reshape(-1) * 256 + s_img.reshape(-1))[::stride]
        counts = np.bincount(codes, minlength=180 * 256).astype(np.float64)
        p = counts[counts > 0] / counts.sum()
        out.append(-(p * np.log2(p)).sum())
    return np.array(out)


@pytest.mark.parametrize("h,w", [(3, 3), (37, 53), (480, 640)])
@pytest.mark.parametrize("hs_subsample", [1, 4])
def test_batch_stats_match_jax(h, w, hs_subsample):
    from facet_tpu.ops.stats import _batch_stats_impl
    from facet_tpu.ops.stats import split_total as jsplit
    from facet_tpu_torch.ops.stats import batch_stats, split_total

    rgb = _photo_like(2, h, w, seed=h * w + hs_subsample)
    want = jax.device_get(jax.jit(
        _batch_stats_impl, static_argnames=("hs_subsample", "entropy_impl"))(
            jnp.asarray(rgb), hs_subsample=hs_subsample, entropy_impl="xla"))
    got = [t.numpy() for t in batch_stats(torch.from_numpy(rgb), hs_subsample)]
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))       # gray hist
    # entropy: within 1e-5 of the exact (float64) value, and within the
    # atol=rtol=1e-5 bound tests/test_pallas_entropy.py pins of the JAX
    # package's (whose float32 reduction drifts 2.9e-5 from the exact value
    # at 480x640)
    np.testing.assert_allclose(got[2], _entropy_f64(rgb, hs_subsample),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    for k, shift in ((1, 12), (3, 12), (4, 16), (5, 12)):
        for j in range(2):
            assert split_total(got[k][j], shift) == jsplit(want[k][j], shift), k


@pytest.mark.parametrize("entropy_impl", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("hs_subsample", [1, 4])
def test_batch_stats_configurations_match_jax(entropy_impl, hs_subsample):
    """Both stats configurations against facet_tpu's own (its Pallas kernels
    in interpret mode): the same tuple, integers identical, entropy within
    atol=rtol=1e-5. In the fast tier pallas_fused runs the pallas
    configuration, on both sides."""
    from facet_tpu.ops.stats import _batch_stats_impl
    from facet_tpu.ops.stats import split_total as jsplit
    from facet_tpu_torch.ops.stats import batch_stats, split_total

    rgb = _photo_like(2, 37, 53, seed=7 + hs_subsample)
    want = jax.device_get(_batch_stats_impl(
        jnp.asarray(rgb), hs_subsample=hs_subsample, entropy_impl=entropy_impl))
    got = [t.numpy() for t in batch_stats(torch.from_numpy(rgb), hs_subsample,
                                          entropy_impl)]
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-5, rtol=1e-5)
    for k, shift in ((1, 12), (3, 12), (4, 16), (5, 12)):
        for j in range(2):
            assert split_total(got[k][j], shift) == jsplit(want[k][j], shift), k


@pytest.mark.parametrize("entropy_impl", ["pallas", "pallas_fused"])
def test_batch_stats_gray_stats_read_the_rgb(monkeypatch, entropy_impl):
    """In both configurations the prepass hands kernel 5 the uint8 RGB batch
    itself (fused_gray_stats_rgb), and makes no gray plane for it."""
    from facet_tpu_torch.ops import stats

    seen = []
    entry = stats.fused_gray_stats_rgb
    monkeypatch.setattr(stats, "fused_gray_stats_rgb",
                        lambda rgb: seen.append(rgb) or entry(rgb))
    rgb = torch.from_numpy(_photo_like(2, 37, 53, seed=5))
    out = stats.batch_stats(rgb, 1, entropy_impl)
    assert len(seen) == 1 and seen[0] is rgb
    assert not hasattr(stats, "rgb_to_gray")
    want = entry(rgb)
    assert torch.equal(out[0], want[0])


def test_resolve_entropy_impl(monkeypatch):
    from facet_tpu_torch.ops.stats import batch_stats, resolve_entropy_impl

    monkeypatch.delenv("FACET_ENTROPY_IMPL", raising=False)
    assert resolve_entropy_impl() == "pallas"
    assert resolve_entropy_impl("pallas_fused") == "pallas_fused"
    monkeypatch.setenv("FACET_ENTROPY_IMPL", "pallas_fused")
    assert resolve_entropy_impl() == "pallas_fused"
    for impl in ("xla", "none", "zero"):         # the TPU's measuring modes
        monkeypatch.setenv("FACET_ENTROPY_IMPL", impl)
        with pytest.raises(ValueError):
            resolve_entropy_impl()
        with pytest.raises(ValueError):
            batch_stats(torch.zeros(1, 3, 3, 3, dtype=torch.uint8), 1, impl)


def test_compute_batch_stats_groups_shapes():
    from facet_tpu.ops.stats import compute_batch_stats as jcompute
    from facet_tpu_torch.ops.stats import compute_batch_stats

    images = list(_photo_like(3, 20, 30, 1)) + list(_photo_like(2, 17, 11, 2))
    images = [images[0], images[3], images[1], images[4], images[2]]
    want = jcompute(images, entropy_impl="xla")
    got = compute_batch_stats(images, "cpu")
    for a, b in zip(got, want):
        assert (a.height, a.width) == (b.height, b.width)
        np.testing.assert_array_equal(a.gray_hist, b.gray_hist)
        assert (a.sat_sum, a.lap_sum, a.lap_sumsq, a.imm_abs_sum) == \
            (b.sat_sum, b.lap_sum, b.lap_sumsq, b.imm_abs_sum)
        assert a.hs_entropy == pytest.approx(b.hs_entropy, abs=1e-5, rel=1e-5)


def _low_coefficients_f64(img):
    """float64 reference of the 8x8 low-frequency block, for tie detection."""
    from facet_tpu_torch.ops.phash import _area_weights, _dct_matrix

    h, w = img.shape[:2]
    x = img.astype(np.int64)
    gray = ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14))
            >> 15).astype(np.float64)
    small = _area_weights(h, 32).astype(np.float64) @ gray \
        @ _area_weights(w, 32).astype(np.float64).T
    d = _dct_matrix().astype(np.float64)
    return (d @ small @ d.T)[:8, :8].reshape(-1)


def test_phash_bits_identical():
    """Rule for ties: a coefficient within 1e-6 of the block's largest
    magnitude (the DC term, ~5e5 here) of the median is a tie: float32
    sums at that scale round by ~0.1, so its bit may fall either side in
    either package and is not compared. Every other bit must be identical,
    and images without a tie must hash identically."""
    from facet_tpu.ops.phash import phash_batch as jphash
    from facet_tpu_torch.ops.phash import phash_batch

    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(3)]
    images += list(_photo_like(3, 97, 61, 6))
    want = jphash(images)
    got = phash_batch(images, "cpu")
    untied = 0
    for img, a, b in zip(images, got, want):
        low = _low_coefficients_f64(img)
        tie = np.abs(low - np.median(low)) <= 1e-6 * np.abs(low).max()
        mask = int("".join("0" if t else "1" for t in tie), 2)
        assert int(a, 16) & mask == int(b, 16) & mask
        if not tie.any():
            assert a == b
            untied += 1
    assert untied >= 5


def test_resize_matrices_identical():
    from facet_tpu.ops import resize as jresize
    from facet_tpu_torch.ops import resize

    for args in ((1024, 224), (1536, 224, 0.2, 37.5), (97, 384, None, 0.0, "linear"),
                 (1024, 384, None, 0.0, "linear")):
        np.testing.assert_array_equal(resize.resample_matrix(*args),
                                      jresize.resample_matrix(*args))
    for shape in ((1024, 1536), (768, 1024), (97, 61)):
        for a, b in zip(resize.clip_preprocess_matrices(*shape),
                        jresize.clip_preprocess_matrices(*shape)):
            np.testing.assert_array_equal(a, b)


def test_apply_separable_resize():
    from facet_tpu.ops import resize as jresize
    from facet_tpu_torch.ops import resize

    img = _photo_like(2, 97, 131, 7)
    rows, cols = resize.clip_preprocess_matrices(97, 131, 56)
    want = np.asarray(jresize.apply_separable_resize(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols)))
    got = resize.apply_separable_resize(torch.from_numpy(img), torch.from_numpy(rows),
                                        torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
