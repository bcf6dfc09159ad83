"""The port's parameter tables against the JAX package's flax trees.

``facet_tpu_torch.params.fallback_values`` must reproduce
``facet_tpu.models.checkpoints.fallback_init`` bit for bit (same leaves,
same order, same float32 values), and ``bridge`` must refuse a tree with a
missing or a surplus key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_tpu_torch import params as P

TINY_CLIP = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4,
                 projection_dim=768)


def fallback_tree(module, seed, perturb=None):
    """The flax tree of a port module's fallback init at ``seed``, built in
    numpy (``P.fallback_values``, held bit for bit to the JAX package's
    ``fallback_init`` below). With ``perturb`` a seed, the 1-D leaves
    (BatchNorm statistics and affine, biases, PReLU slopes) are drawn at
    random instead, scale/var in [0.5, 1.5] and the rest around zero, so
    that no layer of a parity test is an identity."""
    rng = np.random.default_rng(perturb)
    tree = {}
    for path, value in sorted(P.fallback_values(module.flax_layout(), seed).items()):
        if perturb is not None and value.ndim == 1:
            value = (rng.uniform(0.5, 1.5, value.shape) if path[-1] in ("scale", "var")
                     else rng.standard_normal(value.shape) * 0.05).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _flax_flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# the families of the composition and faces members, at the seeds their
# create() uses in both packages
NEW_FAMILIES = ["u2netp", "samp_net", "scrfd", "landmarks", "arcface"]


def _pair(family):
    """(port module, jax module, example input shapes, seed) of one family."""
    from facet_tpu.models import aesthetic as jaes
    from facet_tpu.models import clip as jclip
    from facet_tpu.models import face_models as jfaces
    from facet_tpu.models import samp_net as jsamp
    from facet_tpu.models import scrfd as jscrfd
    from facet_tpu.models import topiq as jtopiq
    from facet_tpu.models import u2netp as ju2
    from facet_tpu_torch.models import (
        aesthetic, clip, face_models, samp_net, scrfd, topiq, u2netp)

    return {
        "clip": lambda: (clip.CLIPVisionTower(clip.CLIPVisionConfig(**TINY_CLIP)),
                         jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**TINY_CLIP)),
                         [(1, 56, 56, 3)], 0),
        "head": lambda: (aesthetic.AestheticHead(), jaes.AestheticHead(), [(1, 768)], 1),
        "topiq": lambda: (topiq.TOPIQNet(topiq.TOPIQConfig(input_size=128)),
                          jtopiq.TOPIQNet(jtopiq.TOPIQConfig(input_size=128)),
                          [(1, 128, 128, 3)], 30),
        "u2netp": lambda: (u2netp.U2NETP(), ju2.U2NETP(), [(1, 64, 64, 3)], 21),
        "samp_net": lambda: (samp_net.SAMPNet(), jsamp.SAMPNet(),
                             [(1, 224, 224, 3), (1, 224, 224, 1)], 20),
        "scrfd": lambda: (scrfd.SCRFD(), jscrfd.SCRFD(), [(1, 160, 160, 3)], 10),
        "landmarks": lambda: (face_models.LandmarkNet(), jfaces.LandmarkNet(),
                              [(1, 192, 192, 3)], 11),
        "arcface": lambda: (face_models.IResNet(), jfaces.IResNet(), [(1, 112, 112, 3)], 12),
    }[family]()


@pytest.mark.parametrize("family", ["clip", "head", "topiq"] + NEW_FAMILIES)
def test_fallback_init_bit_identical(family):
    from facet_tpu.models.checkpoints import fallback_init, sds

    port, flax_mod, shapes, seed = _pair(family)
    want = _flax_flat(fallback_init(flax_mod, *map(sds, shapes), seed=seed))
    got = P.fallback_values(port.flax_layout(), seed=seed)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        assert got[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))


@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_bridge_covers_the_flax_tree(family):
    """bridge() takes the JAX package's whole tree for each new module: it
    raises on a key the module does not cover or a leaf the tree lacks, and
    every torch parameter and buffer it fills ends up equal to its leaf."""
    from facet_tpu.models.checkpoints import fallback_init, sds

    port, flax_mod, shapes, seed = _pair(family)
    tree = jax.tree.map(np.asarray, fallback_init(flax_mod, *map(sds, shapes), seed=seed + 1))
    P.bridge(port, tree)
    flat = _flax_flat(tree)
    leaves = port.flax_layout()
    assert len(leaves) == len(flat)
    filled = {id(leaf.tensor) for leaf in leaves}
    assert all(id(t) in filled for t in port.parameters())
    for leaf in leaves:
        np.testing.assert_array_equal(leaf.tensor.detach().numpy(),
                                      leaf.convert(flat[leaf.path]), err_msg="/".join(leaf.path))


def test_fallback_init_fills_the_module():
    from facet_tpu_torch.models.aesthetic import AestheticHead

    head = P.fallback_init(AestheticHead(), seed=1)
    values = P.fallback_values(head.flax_layout(), seed=1)
    np.testing.assert_array_equal(head.fc1.weight.detach().numpy(),
                                  values[("params", "fc1", "kernel")].T)
    assert torch.count_nonzero(head.fc1.bias) == 0


def _head_tree():
    from facet_tpu.models.aesthetic import AestheticHead
    from facet_tpu.models.checkpoints import fallback_init, sds

    return jax.tree.map(np.asarray, fallback_init(AestheticHead(), sds((1, 768)),
                                                  seed=1))


def test_bridge_raises_on_missing_key():
    from facet_tpu_torch.models.aesthetic import AestheticHead

    tree = _head_tree()
    del tree["params"]["fc2"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        P.bridge(AestheticHead(), tree)


def test_bridge_raises_on_surplus_key():
    from facet_tpu_torch.models.aesthetic import AestheticHead

    tree = _head_tree()
    tree["params"]["fc3"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="surplus"):
        P.bridge(AestheticHead(), tree)


def test_bridge_copies_layouts():
    """Dense (in, out) -> (out, in); DenseGeneral (in, H, D) -> (H*D, in)
    and (H, D, out) -> (out, H*D); conv HWIO -> OIHW; BatchNorm stats."""
    from facet_tpu.models.topiq import ChunkedAttention as JAttn
    from facet_tpu_torch.models.topiq import Bottleneck, ChunkedAttention

    rng = np.random.default_rng(0)
    jattn = JAttn(num_heads=4, qkv_features=32)
    x = jnp.asarray(rng.normal(size=(1, 8, 32)).astype(np.float32))
    tree = jattn.init(jax.random.PRNGKey(0), x, x)["params"]
    attn = ChunkedAttention(4, 32)

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = attn

        def flax_layout(self):
            return attn.flax_layout(("params",))

    P.bridge(Wrap(), {"params": tree})
    with torch.no_grad():
        got = attn(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(x)))
    want = np.asarray(jattn.apply({"params": tree}, x, x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    block = Bottleneck(16, 8, stride=2)
    leaves = block.flax_layout(("blk",))
    kinds = {leaf.path[-1] for leaf in leaves}
    assert {"kernel", "scale", "bias", "mean", "var"} <= kinds
    assert sum(leaf.path[0] == "batch_stats" for leaf in leaves) == 8


def test_load_npz_reads_the_converter_layout(tmp_path, monkeypatch):
    from facet_tpu.models.convert import save_params

    tree = _head_tree()
    save_params(tree, str(tmp_path / "aesthetic_head.npz"))
    monkeypatch.setattr(P, "PRETRAINED_DIR", str(tmp_path))
    loaded = P.load_npz("aesthetic_head")
    np.testing.assert_array_equal(loaded["params"]["fc1"]["kernel"],
                                  tree["params"]["fc1"]["kernel"])
    assert P.load_npz("no_such_checkpoint") is None


def _qwen_pair(family):
    """(port module, the JAX package's flax tree) of a tiny Qwen tower:
    init_text_params for the text model, a flax init for the vision tower."""
    if family == "qwen_text":
        from facet_tpu.models.qwen_text import QwenTextConfig, init_text_params
        from facet_tpu_torch.models import qwen_text

        cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_layers=2,
                   num_heads=4, num_kv_heads=2, mrope_section=(2, 1, 1))
        _, tree = init_text_params(QwenTextConfig(**cfg), seed=3)
        return qwen_text.QwenTextModel(qwen_text.QwenTextConfig(**cfg), device="cpu"), tree
    from facet_tpu.models.qwen_vision import QwenVisionConfig, QwenVisionTower
    from facet_tpu_torch.models import qwen_vision

    cfg = dict(hidden_size=16, out_hidden_size=24, intermediate_size=20, num_heads=2,
               depth=2, patch_size=4, window_size=16, fullatt_block_indexes=(1,))
    x = jnp.zeros((16, QwenVisionConfig(**cfg).patch_dim), jnp.float32)
    tree = jax.jit(QwenVisionTower(QwenVisionConfig(**cfg), 4, 4).init)(
        jax.random.PRNGKey(0), x)
    return qwen_vision.QwenVisionTower(qwen_vision.QwenVisionConfig(**cfg), "cpu"), tree


@pytest.mark.parametrize("family", ["qwen_text", "qwen_vision"])
def test_qwen_bridge_consumes_every_leaf(family):
    """bridge() takes the JAX package's whole Qwen tree: one port leaf per
    flax leaf, each equal to its flax value after the layout change, and no
    element of any port parameter left unfilled (q/k/v and gate/up land in
    views of one fused tensor each)."""
    port, tree = _qwen_pair(family)
    tree = jax.tree.map(np.asarray, tree)
    with torch.no_grad():
        for param in port.parameters():
            param.fill_(float("nan"))
    P.bridge(port, tree)
    flat = _flax_flat(tree)
    leaves = port.flax_layout()
    assert len(leaves) == len(flat)
    assert all(not torch.isnan(p).any() for p in port.parameters())
    for leaf in leaves:
        np.testing.assert_array_equal(leaf.tensor.detach().numpy(),
                                      leaf.convert(flat[leaf.path]), err_msg="/".join(leaf.path))


def test_random_init_fills_every_leaf():
    """random_init_ draws from its generator on the module's device: every
    element set, >=2-D leaves within +-1/sqrt(fan_in), embedding tables
    normal at std 0.02, scales one and biases zero, and the same seed gives
    the same weights."""
    from facet_tpu_torch.models.qwen_vision import QwenVisionConfig, QwenVisionTower
    from facet_tpu_torch.models.qwen_text import QwenTextConfig, QwenTextModel

    cfg = QwenTextConfig(vocab_size=512, hidden_size=32, intermediate_size=48, num_layers=1,
                         num_heads=4, num_kv_heads=2, mrope_section=(2, 1, 1))
    models = [P.random_init_(QwenTextModel(cfg, torch.bfloat16, "cpu"),
                             torch.Generator().manual_seed(8)) for _ in range(2)]
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    for leaf in models[0].flax_layout():
        t = leaf.tensor.float()
        if leaf.path[-1] == "embedding":
            assert abs(t.std().item() - 0.02) < 0.002
        elif len(leaf.shape) >= 2:
            # the bound, rounded to bf16 at most one ulp up
            assert t.abs().max() <= (1 + 2 ** -7) / np.sqrt(leaf.shape[0]) and t.std() > 0
        else:
            assert (t == (1.0 if leaf.path[-1] == "scale" else 0.0)).all(), leaf.path
    tower = P.random_init_(QwenVisionTower(QwenVisionConfig(
        hidden_size=16, out_hidden_size=24, intermediate_size=20, num_heads=2, depth=1),
        "cpu"), torch.Generator().manual_seed(8))
    assert all(torch.isfinite(p).all() for p in tower.parameters())
