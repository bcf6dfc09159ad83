"""The port's two kernels: plain twins against the JAX Pallas kernels.

On the CPU each wrapper computes its plain PyTorch twin; these tests hold
the twins against facet_tpu's Pallas kernels run in interpret mode, at the
shapes tests/test_pallas_entropy.py and tests/test_pallas_attn.py use.
Tolerances: entropy within 1e-5 of the exact float64 value and within the
atol=rtol=1e-5 the JAX tests pin against the JAX kernel (which itself sits
up to 2.2e-5 from the exact value); attention 2e-3, the bound
tests/test_pallas_attn.py:47 pins for the TPU kernel against a bf16 oracle
(measured here: the twin and the interpret-mode kernel differ by up to
3.4e-4, where exp rounding flips a bf16 rounding of p), and 3e-4 for the
error's RMS relative to the output's, which sees where p is rounded.

Tests marked ``cuda`` run the CUDA kernels against the twins and skip
without a card (python -m pytest tests/test_torch_kernels.py -m cuda on
the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_tpu_torch.ops import attention, entropy


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


@pytest.mark.parametrize("case", ["forced_padding", "markers", "stride4"])
def test_entropy_twin_matches_pallas_ilp(case):
    from facet_tpu.ops.pallas_entropy import hs_entropy_pallas_ilp

    if case == "markers":
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


def test_entropy_no_in_range_pixel_is_zero():
    hh = np.full((1, 16), 200, np.int32)
    ss = np.zeros((1, 16), np.int32)
    assert entropy.hs_entropy(torch.from_numpy(hh), torch.from_numpy(ss)).item() == 0.0


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
    # the same rounding points as the TPU kernel, element by element
    rel_rms = np.sqrt(np.mean((got - want).astype(np.float64) ** 2)
                      / np.mean(want.astype(np.float64) ** 2))
    assert rel_rms <= 3e-4


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
def test_attention_kernel_matches_twin(cuda):
    """The largest error only catches gross faults; the error's RMS relative
    to the output's RMS checks that p is rounded to bf16 where the twin
    rounds it (chip_smoke.py states both limits' basis)."""
    q = torch.from_numpy(_rand((2, 4, 1024, 64), 1) / 8).to(cuda)
    k = torch.from_numpy(_rand((2, 4, 256, 64), 2)).to(cuda)
    v = torch.from_numpy(_rand((2, 4, 256, 64), 3)).to(cuda)
    got = attention.cross_attention(q, k, v)
    want = attention.cross_attention_plain(q, k, v)
    diff = (got - want).double()
    assert float(diff.abs().max()) <= 1e-3
    assert float(diff.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt()) <= 3e-4
