"""The composition member of the port against the JAX package.

U2-Net-P, SAMP-Net and ``SAMPComposition`` of ``facet_tpu_torch`` take the
same seeded numpy inputs and the same parameters as their ``facet_tpu``
counterparts: the fallback trees with BatchNorm statistics and biases
drawn at random so that no layer is an identity
(tests/test_torch_params.py:fallback_tree), bridged onto the torch modules.

- U2-Net-P saliency within atol 1e-4 / rtol 1e-3, the bound of
  tests/test_convert_u2netp.py, at a size that pools evenly and at an odd
  one (measured 6e-8 at both);
- SAMP-Net's three heads within 1e-6 (measured at most 4e-8);
- the saliency downsample to the 7x7 grid is the antialiased bilinear
  resize of ``jax.image.resize``, within 1e-6 (measured 1.8e-7). The plain
  bilinear form misses that grid by more than 1e-2, and with it the
  attributes move by 3.8e-6, outside the heads' bound;
- the whole scorer on uint8 photos: pattern weights, attributes and score
  distribution within 1e-4, the score (rounded to 0.01, as stored) within
  0.01, the dominant pattern identical.
"""

import numpy as np
import pytest
import torch

SAMP_TOL = dict(atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def trees():
    """(SAMP-Net, U2-Net-P) flax trees at the create() seeds, perturbed."""
    from test_torch_params import fallback_tree

    from facet_tpu_torch.models.samp_net import SAMPNet
    from facet_tpu_torch.models.u2netp import U2NETP

    return fallback_tree(SAMPNet(), 20, 1), fallback_tree(U2NETP(), 21, 2)


@pytest.fixture(scope="module")
def port_nets(trees):
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models.samp_net import SAMPNet
    from facet_tpu_torch.models.u2netp import U2NETP

    samp_tree, u2_tree = trees
    return (P.bridge(SAMPNet(), samp_tree).eval(), P.bridge(U2NETP(), u2_tree).eval())


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 37, 53)], ids=["even", "odd"])
def test_u2netp_saliency(trees, port_nets, shape):
    """Ceil-mode pools of odd sides and bilinear upsampling at non-integer
    scales agree with flax's."""
    import jax

    from facet_tpu.models.u2netp import U2NETP

    x = np.random.default_rng(0).standard_normal(shape + (3,)).astype(np.float32) * 0.5
    want = np.asarray(jax.jit(U2NETP().apply)(trees[1], x))
    with torch.no_grad():
        got = port_nets[1](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape + (1,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def samp_inputs():
    rng = np.random.default_rng(3)
    image = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    saliency = rng.uniform(0, 1, (2, 224, 224, 1)).astype(np.float32)
    return image, saliency


@pytest.fixture(scope="module")
def samp_heads(trees, samp_inputs):
    import jax

    from facet_tpu.models.samp_net import SAMPNet

    return [np.asarray(o) for o in jax.jit(SAMPNet().apply)(trees[0], *samp_inputs)]


def _port_heads(net, samp_inputs):
    with torch.no_grad():
        return [o.numpy() for o in net(*(torch.from_numpy(a) for a in samp_inputs))]


def test_samp_net_heads(port_nets, samp_inputs, samp_heads):
    got = _port_heads(port_nets[0], samp_inputs)
    for g, w, name in zip(got, samp_heads, ("pattern_weights", "attributes", "score_dist")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **SAMP_TOL)


def test_saliency_resize_is_antialiased(port_nets, samp_inputs, samp_heads, monkeypatch):
    """The 56x56 -> 7x7 saliency resize must be jax.image.resize's
    antialiased bilinear: the plain bilinear form misses it by far more than
    its bound, and the heads computed with it leave theirs."""
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    from facet_tpu.models.samp_net import _maxpool_k3s2p1
    from facet_tpu_torch.models import samp_net

    sal = samp_inputs[1]
    pooled = _maxpool_k3s2p1(_maxpool_k3s2p1(jnp.asarray(sal)))
    want = np.asarray(jax.image.resize(pooled, (2, 7, 7, 1), "bilinear"))
    got = samp_net.saliency_to_grid(torch.from_numpy(sal), 7, 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)

    def plain(saliency, h, w):
        s = samp_net._maxpool_k3s2p1(samp_net._maxpool_k3s2p1(saliency))
        return F.interpolate(s.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)

    assert np.abs(plain(torch.from_numpy(sal), 7, 7).numpy() - want).max() > 1e-2
    monkeypatch.setattr(samp_net, "saliency_to_grid", plain)
    got = _port_heads(port_nets[0], samp_inputs)
    assert not all(np.allclose(g, w, **SAMP_TOL) for g, w in zip(got, samp_heads))


def test_samp_composition_scores(trees, monkeypatch):
    """The whole scorer on uint8 photos: the device resize to 224, U2-Net-P
    and SAMP-Net, then the 0-10 rescale and the dominant pattern."""
    monkeypatch.setenv("FACET_DISABLE_DP", "1")
    from facet_tpu.models.samp_net import SAMPComposition as JSAMP
    from facet_tpu_torch import params as P
    from facet_tpu_torch.models.samp_net import SAMPComposition, SAMPNet
    from facet_tpu_torch.models.u2netp import U2NETP

    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (61, 45, 3), dtype=np.uint8) for _ in range(2)]
    want = JSAMP(*trees).score_batch(images)
    port = SAMPComposition(P.bridge(SAMPNet(), trees[0]), P.bridge(U2NETP(), trees[1]),
                           "cpu")
    got = port.score_batch(images)
    for g, w in zip(got, want):
        assert g["pattern"] == w["pattern"]
        assert g["score"] == pytest.approx(w["score"], abs=0.01)
        assert g["power_point_score"] == pytest.approx(w["power_point_score"], abs=0.01)
        for key in ("attributes", "score_distribution"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
        np.testing.assert_allclose(list(g["pattern_weights"].values()),
                                   list(w["pattern_weights"].values()), atol=1e-4)


def test_samp_forward_runs_full_float32(port_nets):
    """U2-Net-P and SAMP-Net own their precision, as the JAX package
    computes them in float32: whatever TF32 settings the process holds, the
    scorer's forward runs both with TF32 off for cuDNN and matmuls, and the
    caller's settings come back afterwards."""
    from facet_tpu_torch.models.samp_net import SAMPComposition

    scorer = SAMPComposition(*port_nets, "cpu")
    seen = []
    hooks = [net.register_forward_pre_hook(lambda module, _: seen.append(
        (type(module).__name__, torch.backends.cudnn.allow_tf32,
         torch.get_float32_matmul_precision()))) for net in port_nets]
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        heads = scorer.forward_u8(torch.from_numpy(
            np.random.default_rng(5).integers(0, 256, (1, 40, 48, 3), dtype=np.uint8)))
        after = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        for hook in hooks:
            hook.remove()
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert sorted(seen) == [("SAMPNet", False, "highest"), ("U2NETP", False, "highest")]
    assert after == (True, "high")
    assert [tuple(h.shape) for h in heads] == [(1, 8), (1, 6), (1, 5)]
