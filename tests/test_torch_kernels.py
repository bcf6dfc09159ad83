"""The port's kernels: plain twins against the JAX Pallas kernels.

On the CPU each wrapper computes its plain PyTorch twin; these tests hold
the twins against facet_tpu's Pallas kernels run as their own tests run
them (interpret mode, or the XLA path of ``pallas_stats.fused_gray_stats``),
at the shapes tests/test_pallas_entropy.py, test_pallas_fused_stats.py,
test_pallas_stats.py and test_pallas_attn.py use, plus odd shapes (h*w % 4
!= 0, 3x3). Histograms and integer sums must be identical.
Tolerances: entropy within 1e-5 of the exact float64 value and within the
atol=rtol=1e-5 the JAX tests pin against the JAX kernel (which itself sits
up to 2.2e-5 from the exact value); attention 2e-3, the bound
tests/test_pallas_attn.py:47 pins for the TPU kernel against a bf16 oracle
(measured here: the twin and the interpret-mode kernel differ by up to
3.4e-4, where exp rounding flips a bf16 rounding of p), and 3e-4 for the
error's RMS relative to the output's, which sees where p is rounded
(rounding exp(s - m) before dividing by l, an online softmax's order,
reads 2.2e-3).
The ViT's two attention kernels work in bf16: the row softmax (kernel 6)
within one bf16 ulp of ``softmax_pallas`` element by element (measured: 25
of 2.1 million elements differ, each by one ulp, where f32 exp or sum order
rounds the other way); the fused attention (kernel 7) within one bf16 ulp
of the output's largest magnitude and 3e-4 relative RMS of
``clip._flash_attention`` (measured: 2.0e-3 and 6.1e-5; rounding p before
normalizing it instead gives 3e-3, which the RMS limit rejects).

Tests marked ``cuda`` run the CUDA kernels against the twins and skip
without a card (python -m pytest tests/test_torch_kernels.py -m cuda on
the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_tpu_torch.ops import (
    attention, entropy, flash_attention, fused_stats, gray_stats, softmax)
from facet_tpu_torch.ops.stats import split_total


def _rand_hs(b, n, seed):
    rng = np.random.default_rng(seed)
    hh = (rng.gamma(2.0, 12.0, (b, n)).astype(np.int32)) % 180
    ss = rng.integers(0, 256, (b, n)).astype(np.int32)
    return hh, ss


def _oracle_entropy(hh, ss):
    out = []
    for h, s in zip(hh, ss):
        keep = (h >= 0) & (h < 180)
        counts = np.bincount(h[keep] * 256 + s[keep], minlength=180 * 256)
        p = counts[counts > 0] / counts.sum()
        out.append(-(p * np.log2(p)).sum())
    return np.array(out)


def _edge_hs(case):
    """Kernel 1's edge inputs: every pixel in one bin (entropy 0), and
    planes of 37 x 53 pixels, an odd length that no slice or vector width
    divides."""
    if case == "one_bin":
        return np.full((2, 4096), 17, np.int32), np.full((2, 4096), 201, np.int32)
    return _rand_hs(3, 37 * 53, 9)


@pytest.mark.parametrize("case", ["forced_padding", "markers", "stride4", "one_bin",
                                  "odd_length"])
def test_entropy_twin_matches_pallas_ilp(case):
    from facet_tpu.ops.pallas_entropy import hs_entropy_pallas_ilp

    if case in ("one_bin", "odd_length"):
        hh, ss = _edge_hs(case)
    elif case == "markers":
        # -1 hue markers vanish from the histogram and the denominator
        h0, s0 = _rand_hs(1, 3000, 3)
        hh = np.full((1, 4096), -1, np.int32)
        hh[:, :3000] = h0
        ss = np.zeros((1, 4096), np.int32)
        ss[:, :3000] = s0
    else:
        hh, ss = _rand_hs(2, 5000, 2)      # forces padding to the 64K block
    stride = 4 if case == "stride4" else 1
    want = np.asarray(hs_entropy_pallas_ilp(
        jnp.asarray(hh[:, ::stride]), jnp.asarray(ss[:, ::stride]),
        interpret=True))
    got = entropy.hs_entropy(torch.from_numpy(hh), torch.from_numpy(ss),
                             stride=stride).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, _oracle_entropy(hh[:, ::stride], ss[:, ::stride]),
                               atol=1e-5, rtol=0)


def test_entropy_histogram_and_wrapper_checks():
    hh, ss = _rand_hs(2, 777, 4)
    got, hist = entropy.hs_entropy_with_histogram(torch.from_numpy(hh),
                                                  torch.from_numpy(ss), 3)
    want = np.stack([np.bincount(h[::3] * 256 + s[::3], minlength=46080)
                     for h, s in zip(hh, ss)])
    np.testing.assert_array_equal(hist.numpy(), want)
    assert entropy.hs_entropy.launches == 0          # the CPU never launches
    with pytest.raises(TypeError):
        entropy.hs_entropy(torch.zeros(1, 4), torch.zeros(1, 4))
    with pytest.raises(ValueError):
        entropy.hs_entropy(torch.zeros(1, 4, dtype=torch.int32),
                           torch.zeros(1, 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        entropy.hs_entropy(torch.zeros(2, 4, dtype=torch.int32).t(),
                           torch.zeros(2, 4, dtype=torch.int32).t())
    with pytest.raises(ValueError):
        entropy.hs_entropy(torch.zeros(1, 4, dtype=torch.int32),
                           torch.zeros(1, 4, dtype=torch.int32), n_valid=0)


def test_entropy_no_in_range_pixel_is_zero():
    hh = np.full((1, 16), 200, np.int32)
    ss = np.zeros((1, 16), np.int32)
    assert entropy.hs_entropy(torch.from_numpy(hh), torch.from_numpy(ss)).item() == 0.0


@pytest.mark.parametrize("case", ["oracle", "rgb", "n_valid"])
def test_entropy_fixed_denominator_twin_matches_pallas(case):
    """Kernel 3: the round-2 cases of tests/test_pallas_entropy.py, and one
    with a fixed denominator over -1 markers (which count in n_valid but in
    no bin)."""
    from facet_tpu.ops.pallas_entropy import hs_entropy_pallas

    n_valid = None
    if case == "oracle":
        hh, ss = _rand_hs(2, 4000, 0)      # forces padding to the 64K block
    elif case == "rgb":
        from facet_tpu_torch.ops.colorspace import rgb_to_hsv

        rgb = np.random.default_rng(1).integers(0, 256, (2, 24, 32, 3)).astype(np.uint8)
        h, s, _ = rgb_to_hsv(torch.from_numpy(rgb))
        hh, ss = h.reshape(2, -1).numpy(), s.reshape(2, -1).numpy()
    else:
        hh, ss = _rand_hs(2, 3000, 5)
        hh[:, 2500:] = -1
        n_valid = 3000
    want = np.asarray(hs_entropy_pallas(jnp.asarray(hh), jnp.asarray(ss),
                                        n_valid=n_valid, interpret=True))
    got = entropy.hs_entropy(torch.from_numpy(hh), torch.from_numpy(ss),
                             n_valid=n_valid).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if n_valid is None:
        np.testing.assert_allclose(got, _oracle_entropy(hh, ss), atol=1e-5, rtol=0)
    else:
        counts = [np.bincount(h[h >= 0] * 256 + s[h >= 0]) for h, s in zip(hh, ss)]
        exact = [-(c[c > 0] / n_valid * np.log2(c[c > 0] / n_valid)).sum() for c in counts]
        np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0)


def _images(b, h, w, seed):
    """tests/test_pallas_fused_stats.py's images: uniform noise with a gray
    (diff = 0), a black (v = 0) and a pure red pixel."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    base[:, 0, 0] = 128
    base[:, 0, 1] = 0
    base[:, 0, 2] = [255, 0, 0]
    return base


@pytest.mark.parametrize("shape", [(2, 40, 56), (1, 64, 72), (1, 37, 53)])
def test_fused_stats_twin_matches_pallas(shape):
    """Kernel 4; (1, 37, 53) has h*w % 4 != 0, which the TPU kernel's packed
    lanes never met in its own tests."""
    from facet_tpu.ops.pallas_fused_stats import fused_stats_pallas
    from facet_tpu.ops.stats import split_total as jsplit

    imgs = _images(*shape, seed=3)
    want = [np.asarray(x) for x in fused_stats_pallas(jnp.asarray(imgs), interpret=True)]
    got = [t.numpy() for t in fused_stats.fused_stats(torch.from_numpy(imgs))]
    np.testing.assert_array_equal(got[1], want[1])                 # gray hist
    for i in range(shape[0]):
        assert split_total(got[2][i], 12) == jsplit(want[2][i], 12)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 120, 170), (1, 3, 3), (2, 37, 53)])
def test_gray_stats_twin_matches_jax(shape):
    """Kernel 5 against pallas_stats.fused_gray_stats on its XLA path."""
    from facet_tpu.ops.pallas_stats import fused_gray_stats as jax_gray_stats

    gray = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.int32)
    want = jax_gray_stats(jnp.asarray(gray))
    got = gray_stats.fused_gray_stats(torch.from_numpy(gray))
    assert got[0].dtype == torch.int32
    assert all(t.dtype == torch.int64 for t in got[1:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(3, 120, 170), (1, 3, 3), (2, 37, 53)])
def test_gray_stats_rgb_twin_matches_jax(shape):
    """Kernel 5's RGB entry against pallas_stats.fused_gray_stats on the JAX
    package's exact-cv2 gray of the same pixels."""
    from facet_tpu.ops import colorspace as jcs
    from facet_tpu.ops.pallas_stats import fused_gray_stats as jax_gray_stats

    rgb = _images(*shape, seed=sum(shape) + 1)
    want = jax_gray_stats(jcs.rgb_to_gray(jnp.asarray(rgb)))
    got = gray_stats.fused_gray_stats_rgb(torch.from_numpy(rgb))
    assert got[0].dtype == torch.int32
    assert all(t.dtype == torch.int64 for t in got[1:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stats_wrappers_check_inputs():
    rgb = torch.zeros(1, 4, 5, 3, dtype=torch.uint8)
    fused_stats.fused_stats(rgb)
    gray_stats.fused_gray_stats(torch.zeros(1, 4, 5, dtype=torch.int32))
    gray_stats.fused_gray_stats_rgb(rgb)
    assert fused_stats.fused_stats.launches == 0     # the CPU never launches
    assert gray_stats.fused_gray_stats.launches == 0
    assert gray_stats.fused_gray_stats_rgb.launches == 0
    with pytest.raises(TypeError):
        gray_stats.fused_gray_stats_rgb(rgb.to(torch.int32))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats_rgb(torch.zeros(1, 4, 5, 4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats_rgb(torch.zeros(4, 5, 3, dtype=torch.uint8))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats_rgb(torch.zeros(1, 1, 5, 3, dtype=torch.uint8))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats_rgb(torch.zeros(1, 4, 1, 3, dtype=torch.uint8))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats_rgb(torch.zeros(1, 5, 4, 3, dtype=torch.uint8)
                                        .transpose(1, 2))
    with pytest.raises(TypeError):
        fused_stats.fused_stats(rgb.to(torch.int32))
    with pytest.raises(ValueError):
        fused_stats.fused_stats(torch.zeros(1, 4, 5, 4, dtype=torch.uint8))
    with pytest.raises(TypeError):
        gray_stats.fused_gray_stats(torch.zeros(1, 4, 5, dtype=torch.int64))
    with pytest.raises(ValueError):
        gray_stats.fused_gray_stats(torch.zeros(1, 1, 5, dtype=torch.int32))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("b,h,nq,nk,d,qb", [
    (2, 2, 1024, 256, 64, 512),
    (1, 4, 512, 128, 32, 256),
])
def test_attention_twin_matches_pallas(b, h, nq, nk, d, qb):
    from facet_tpu.ops.pallas_attn import cross_attention_pallas

    q = (_rand((b, h, nq, d), 1) / np.sqrt(d)).astype(np.float32)
    k = _rand((b, h, nk, d), 2)
    v = _rand((b, h, nk, d), 3)
    want = np.asarray(cross_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_block=qb, interpret=True))
    got = attention.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_block=qb).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    # the same rounding points as the TPU kernel, element by element; the
    # planted other order (an online softmax's) is outside the limit
    assert _rel_rms(got, want) <= 3e-4
    assert _rel_rms(_cross_round_then_normalize(q, k, v), want) > 3e-4


def test_supported_shape_gate_agrees():
    from facet_tpu.ops import pallas_attn

    for nq in (144, 257, 512, 576, 1024, 2304, 4096, 9216):
        for nk in (128, 144, 256, 576, 1024, 2304):
            for qb in (None, 256):
                assert attention.supported_shape(nq, nk, qb) == \
                    pallas_attn.supported_shape(nq, nk, qb), (nq, nk, qb)
    with pytest.raises(ValueError):
        attention.cross_attention(torch.zeros(1, 1, 257, 64), torch.zeros(1, 1, 257, 64),
                                  torch.zeros(1, 1, 257, 64))


def _bf16(shape, seed, scale=1.0):
    """Seeded normal values rounded to bf16, as float32 numpy: both
    frameworks read the same bf16 numbers from it."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|."""
    return np.ldexp(1.0, np.frexp(np.abs(np.asarray(x, np.float32)))[1] - 8)


def _within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    return diff, (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()


def _rel_rms(got, want):
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.sqrt(np.mean(diff ** 2) / np.mean(np.asarray(want, np.float64) ** 2)))


@pytest.mark.parametrize("shape", [(2, 16, 257, 257), (1, 3, 64, 128), (1, 3, 37, 53),
                                   (1, 2, 8, 1024), (1, 2, 8, 1)])
def test_softmax_twin_matches_pallas(shape):
    """Scores at the ViT's scale, x4 as tests/test_pallas_softmax.py makes
    them; (1, 3, 64, 128) has heads the TPU's head_block does not divide;
    the CUDA kernel's edge paths: 111 rows of an odd width (fewer than one
    group of rows), rows of 1024 (the widest it takes) and of 1."""
    from facet_tpu.ops.pallas_softmax import softmax_pallas

    s = _bf16(shape, sum(shape), 4.0)
    want = np.asarray(softmax_pallas(jnp.asarray(s, jnp.bfloat16), interpret=True),
                      np.float32)
    got = softmax.softmax(torch.from_numpy(s).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    diff, ok = _within_one_ulp(got.float().numpy(), want)
    assert ok
    assert (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(got.float().sum(-1).numpy(), 1.0, atol=1e-2)


def test_softmax_wrapper():
    """float32 scores stay float32 on the CPU and equal the twin; the shape
    is checked."""
    s = torch.from_numpy(_bf16((1, 4, 9, 11), 3, 4.0))
    launches = softmax.softmax.launches
    assert torch.equal(softmax.softmax(s), softmax.softmax_plain(s))
    assert softmax.softmax(s).dtype == torch.float32
    assert softmax.softmax.launches == launches       # the twin, not the kernel
    with pytest.raises(ValueError):
        softmax.softmax(s[0])


def _to_bf16(x):
    """float64 numpy of x rounded to bf16."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def _cross_round_then_normalize(q, k, v):
    """Kernel 2's planted variant: exp(s - m) rounded to bf16 before it is
    divided by l (what a one-pass online softmax does), as float64 numpy."""
    qb, kb, vb = (_to_bf16(x) for x in (q, k, v))
    s = (qb @ kb.transpose(0, 1, 3, 2)).astype(np.float32)
    e = np.exp(s - s.max(-1, keepdims=True))
    return (_to_bf16(e) @ vb) / e.sum(-1, keepdims=True, dtype=np.float64)


def _round_then_normalize(q, k, v, scale):
    """The planted variant: p rounded to bf16 before it is normalized
    (the TPU kernel's multi-block order), as float64 numpy."""
    qt, kt, vt = (np.asarray(x, np.float64).transpose(0, 2, 1, 3) for x in (q, k, v))
    s = (qt @ kt.transpose(0, 1, 3, 2)).astype(np.float32) * np.float32(scale)
    e = np.exp(s - s.max(-1, keepdims=True))
    out = (_to_bf16(e) @ vt) / e.sum(-1, keepdims=True, dtype=np.float64)
    return out.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,d", [(2, 257, 16, 64), (2, 37, 4, 32)])
def test_flash_attention_twin_matches_jax(b, s, h, d):
    """Against clip._flash_attention, which runs JAX's Pallas flash kernel
    in interpret mode on the CPU; 37 tokens pad to 128 there. The RMS limit
    tells the kernel's rounding order from the planted variant's."""
    from facet_tpu.models.clip import _flash_attention

    q, k, v = (_bf16((b, s, h, d), seed, scale)
               for seed, scale in ((1, 1.5), (2, 1.0), (3, 1.0)))
    want = np.asarray(_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                       d ** -0.5), np.float32)
    got = flash_attention.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), d ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, d)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())
    assert _rel_rms(got, want) <= 3e-4
    assert _rel_rms(_round_then_normalize(q, k, v, d ** -0.5), want) > 3e-4


def test_flash_attention_wrapper():
    """Shapes, dtypes and devices of q, k, v are checked; a CPU tensor runs
    the twin, not the kernel."""
    q = torch.from_numpy(_bf16((1, 257, 2, 64), 4))
    launches = flash_attention.flash_attention.launches
    flash_attention.flash_attention(q, q, q, 0.125)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q[:, :200], q, 0.125)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q.double(), q, 0.125)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(*(torch.zeros(1, 9, 2, 64, dtype=torch.int32),) * 3,
                                        0.125)
    assert flash_attention.flash_attention.launches == launches


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 4])
def test_entropy_kernel_matches_twin(cuda, stride):
    hh, ss = _rand_hs(3, 100_003, 7)
    hue, sat = torch.from_numpy(hh).to(cuda), torch.from_numpy(ss).to(cuda)
    got, hist = entropy.hs_entropy_with_histogram(hue, sat, stride)
    assert torch.equal(hist, entropy.hs_histogram_plain(hue, sat, stride))
    want = entropy.hs_entropy_plain(hue, sat, stride)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_bin", "odd_length"])
def test_entropy_kernel_edge_cases(cuda, case):
    hh, ss = _edge_hs(case)
    hue, sat = torch.from_numpy(hh).to(cuda), torch.from_numpy(ss).to(cuda)
    got, hist = entropy.hs_entropy_with_histogram(hue, sat)
    assert torch.equal(hist, entropy.hs_histogram_plain(hue, sat))
    assert float((got - entropy.hs_entropy_plain(hue, sat)).abs().max()) <= 1e-5
    if case == "one_bin":
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_entropy_kernel_is_reproducible(cuda):
    """The reduce sums in a fixed order: two calls give the same bits."""
    hh, ss = _rand_hs(4, 300_001, 10)
    hue, sat = torch.from_numpy(hh).to(cuda), torch.from_numpy(ss).to(cuda)
    assert torch.equal(entropy.hs_entropy(hue, sat), entropy.hs_entropy(hue, sat))


@pytest.mark.cuda
def test_entropy_fixed_denominator_kernel_matches_twin(cuda):
    hh, ss = _rand_hs(3, 100_003, 8)
    hh[:, -1000:] = -1
    hue, sat = torch.from_numpy(hh).to(cuda), torch.from_numpy(ss).to(cuda)
    got = entropy.hs_entropy(hue, sat, n_valid=100_003)
    want = entropy.hs_entropy_plain(hue, sat, n_valid=100_003)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 3), (3, 37, 53), (2, 480, 641)])
def test_fused_stats_kernel_matches_twin(cuda, shape):
    rgb = torch.from_numpy(_images(*shape, seed=11)).to(cuda)
    got = fused_stats.fused_stats(rgb)
    want = fused_stats.fused_stats_plain(rgb)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert float((got[0] - want[0]).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 3), (3, 37, 53), (2, 481, 641)])
def test_gray_stats_kernel_matches_twin(cuda, shape):
    gray = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.int32)
    gray = torch.from_numpy(gray).to(cuda)
    for g, w in zip(gray_stats.fused_gray_stats(gray),
                    gray_stats.fused_gray_stats_plain(gray)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 3), (3, 37, 53), (2, 481, 641), "offset"])
def test_gray_stats_rgb_kernel_matches_twin(cuda, shape):
    """The RGB entry; "offset" starts the batch one byte past an aligned
    address, so no row starts on a 16-byte boundary."""
    if shape == "offset":
        flat = torch.from_numpy(_images(2, 97, 131, seed=13)).reshape(-1).to(cuda)
        rgb = torch.cat([flat.new_zeros(1), flat])[1:].view(2, 97, 131, 3)
    else:
        rgb = torch.from_numpy(_images(*shape, seed=12)).to(cuda)
    for g, w in zip(gray_stats.fused_gray_stats_rgb(rgb),
                    gray_stats.fused_gray_stats_rgb_plain(rgb)):
        assert torch.equal(g, w)


def _big_photo(kind, device):
    """One 24 MP photo (4000 x 6000): "near_uniform", one colour with every
    997th pixel random (nearly every pixel in one bin, past 2^24 of them),
    or "noisy", every channel uniform."""
    rng = np.random.default_rng(24)
    noise = rng.integers(0, 256, (1, 4000, 6000, 3), dtype=np.uint8)
    if kind == "near_uniform":
        rgb = np.empty_like(noise)
        rgb[...] = (90, 140, 200)
        rgb.reshape(-1, 3)[::997] = noise.reshape(-1, 3)[::997]
        noise = rgb
    return torch.from_numpy(noise).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near_uniform", "noisy"])
@pytest.mark.parametrize("kernel", ["hs_entropy", "fused_stats", "gray_stats",
                                    "gray_stats_rgb"])
def test_stats_kernels_above_16mp(cuda, kernel, kind):
    """Kernels 1, 4 and 5 (both entries) on one 24 MP photo: every count
    and integer sum identical to the twins, which count in int64."""
    from facet_tpu_torch.ops.colorspace import rgb_to_gray, rgb_to_hsv

    rgb = _big_photo(kind, cuda)
    if kernel == "hs_entropy":
        hh, ss, _ = rgb_to_hsv(rgb)
        hue, sat = hh.reshape(1, -1).contiguous(), ss.reshape(1, -1).contiguous()
        got, hist = entropy.hs_entropy_with_histogram(hue, sat)
        assert torch.equal(hist, entropy.hs_histogram_plain(hue, sat))
        assert float((got - entropy.hs_entropy_plain(hue, sat)).abs().max()) <= 1e-5
    elif kernel == "fused_stats":
        got = fused_stats.fused_stats(rgb)
        want = fused_stats.fused_stats_plain(rgb)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert float((got[0] - want[0]).abs().max()) <= 1e-5
    else:
        gray = rgb_to_gray(rgb).contiguous()
        got = (gray_stats.fused_gray_stats_rgb(rgb) if kernel == "gray_stats_rgb"
               else gray_stats.fused_gray_stats(gray))
        for g, w in zip(got, gray_stats.fused_gray_stats_plain(gray)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(1024, 256), (1024, 128), (1024, 384), (1536, 128)])
def test_attention_kernel_matches_twin(cuda, nq, nk):
    """The smallest gated shapes (1024 queries: a 192-row query tile with
    a ragged last block; 128 keys: one key stage; 384: three) and 1536
    queries (whole tiles). The largest error only catches gross faults; the
    error's RMS relative to the output's RMS checks that p is rounded to
    bf16 where the twin rounds it (chip_smoke.py states both limits'
    basis)."""
    q = torch.from_numpy(_rand((2, 4, nq, 64), 1) / 8).to(cuda)
    k = torch.from_numpy(_rand((2, 4, nk, 64), 2)).to(cuda)
    v = torch.from_numpy(_rand((2, 4, nk, 64), 3)).to(cuda)
    got = attention.cross_attention(q, k, v)
    want = attention.cross_attention_plain(q, k, v)
    diff = (got - want).double()
    assert float(diff.abs().max()) <= 1e-3
    assert float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()) <= 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 257, 257), (3, 3, 37, 53), (1, 3, 37, 53),
                                   (1, 2, 8, 1024), (1, 2, 8, 1), "offset"])
def test_softmax_kernel_matches_twin(cuda, shape):
    """The ViT's width, whole groups of rows with a ragged last one, fewer
    rows than a group, the widest and the narrowest rows, and ("offset")
    a base 2 bytes off a 16-byte boundary, which takes the row-by-row
    path."""
    offset = shape == "offset"
    shape = (2, 16, 257, 257) if offset else shape
    s = torch.from_numpy(_bf16(shape, 12, 4.0)).to(cuda).to(torch.bfloat16)
    if offset:
        s = torch.cat([s.new_zeros(1), s.reshape(-1)])[1:].view(shape)
    got, want = softmax.softmax(s), softmax.softmax_plain(s)
    _, ok = _within_one_ulp(got.float().cpu().numpy(), want.float().cpu().numpy())
    assert ok


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2, 257), (2, 37), (2, 65), (2, 400)])
def test_flash_attention_kernel_matches_twin(cuda, b, s):
    """257 tokens: a lone last query row and key; 37: one partial tile; 65:
    one row past a 64-row tile; 400: the longest sequence the kernel takes."""
    q, k, v = (torch.from_numpy(_bf16((b, s, 16, 64), seed, scale)).to(cuda).to(torch.bfloat16)
               for seed, scale in ((5, 1.5), (6, 1.0), (7, 1.0)))
    got = flash_attention.flash_attention(q, k, v, 0.125).float().cpu().numpy()
    want = flash_attention.flash_attention_plain(q, k, v, 0.125).float().cpu().numpy()
    assert np.abs(got - want).max() <= _bf16_ulp(np.abs(want).max())
    assert _rel_rms(got, want) <= 3e-4
