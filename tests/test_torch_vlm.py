"""The Qwen2.5-VL tagger of the port against facet_tpu's, on the CPU.

Tiny configurations (the JAX package's own test sizes), parameters from
``init_text_params`` and a flax ``init`` bridged onto the port, inputs from
numpy seeds:

- the text model's logits at float32 (atol TEXT_F32_TOL) and, with every
  leaf cast to bf16 as the JAX tagger casts it, at bf16 (within
  TEXT_BF16_SHARE of the logits' largest magnitude), in the cache-less
  forward and in the cached prefill (valid slots: a pad query attends to
  nothing, and the two packages average its masked row over different
  widths); a cached decode against the cache-less forward; greedy tokens
  identical to the JAX decoder's at float32 with a left- and a
  right-padded row, a row that stops early and a batch that stops early;
  ``rope_index_batch`` identical, left-padded rows included;
- the vision tower on a whole-window grid and on a padded-window grid
  (atol VISION_TOL), and a two-image ``encode``;
- ``device_generate`` of both packages through the stand-in processor of
  chip_smoke.py (whose image half is held to transformers'
  Qwen2VLImageProcessor here): identical replies and tag lists;
- the tagger chain: with nothing installed, the three taggers print the
  JAX package's "unavailable" lines; each install the port does not run
  yet makes ``python -m facet_tpu_torch`` exit 2 before any row; and the
  default scan under the "24gb" profile with the tiny tagger registered
  writes the JAX package's ``tags`` column, and without it CLIP's tags.
"""

import contextlib
import io
import json
import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facet_tpu_torch import params as P

TEXT_F32_TOL = 1e-4
# bf16 bound: at most 3% of the logits' largest magnitude (about four bf16
# ulps there; measured on these sizes at most 1.3%)
TEXT_BF16_SHARE = 0.03
VISION_TOL = 2e-5

TINY_TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
                 num_heads=4, num_kv_heads=2, mrope_section=(4, 2, 2), rope_theta=1e4,
                 tie_word_embeddings=False)
TINY_VISION = dict(hidden_size=32, out_hidden_size=64, intermediate_size=48, num_heads=2,
                   depth=2, patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                   window_size=16, fullatt_block_indexes=(1,))
# the stand-in processor's ids inside the tiny vocabulary, and small images
TINY_SPECIALS = {"<|endoftext|>": 250, "<|im_start|>": 251, "<|im_end|>": 252,
                 "<|vision_start|>": 253, "<|vision_end|>": 254, "<|image_pad|>": 255}
TINY_PIXELS = dict(patch_size=4, merge_size=2, min_pixels=64, max_pixels=2048)
MAX_NEW = 12


def _text():
    from facet_tpu.models import qwen_text as jt
    from facet_tpu_torch.models import qwen_text as tt

    _, params = jt.init_text_params(jt.QwenTextConfig(**TINY_TEXT), seed=5)
    return (jt.QwenTextConfig(**TINY_TEXT), tt.QwenTextConfig(**TINY_TEXT),
            jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def text():
    return _text()


def _bf16(params):
    return {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params["params"])}


def _port_text(tcfg, params, dtype=torch.float32):
    from facet_tpu_torch.models.qwen_text import QwenTextModel

    return P.bridge(QwenTextModel(tcfg, dtype, "cpu"), params)


def _batch(seed=0, b=2, t=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY_TEXT["vocab_size"], (b, t))
    # distinct t/h/w streams exercise the mrope section interleave
    pos = np.stack([rng.integers(0, 30, (b, t)) for _ in range(3)])
    valid = np.ones((b, t), bool)
    valid[0, :3] = False            # left-padded
    valid[1, -2:] = False           # right-padded
    return ids, pos, valid


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16-cached"])
def test_text_logits(case):
    """Logits of the cache-less forward (causal mask), and of the cached
    prefill at the valid slots."""
    from facet_tpu.models import qwen_text as jt

    jcfg, tcfg, params = _text()
    bf16 = case.startswith("bf16")
    jparams = _bf16(params) if bf16 else params
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    ids, pos, valid = _batch()
    b, t = ids.shape
    model = _port_text(tcfg, params, tdtype)
    embeds = np.asarray(jt.embed_tokens(jparams, jnp.asarray(ids)), np.float32)
    mask = np.tril(np.ones((t, t), bool))[None].repeat(b, 0)
    args, cache, tcache, rows = (embeds, pos, mask), None, None, np.ones((b, t), bool)
    if case == "bf16-cached":
        total, kv, hd = t + 4, tcfg.num_kv_heads, tcfg.head_dim
        mask = mask & valid[:, None, :]
        cache = [{"k": jnp.zeros((b, total, kv, hd)), "v": jnp.zeros((b, total, kv, hd))}
                 for _ in range(tcfg.num_layers)]
        tcache = [(torch.zeros(b, kv, total, hd), torch.zeros(b, kv, total, hd))
                  for _ in range(tcfg.num_layers)]
        args, rows = (embeds, pos, np.pad(mask, ((0, 0), (0, 0), (0, 4)))), valid
    want, _ = jax.jit(jt.QwenTextModel(jcfg, jdtype).apply)(
        jparams, *map(jnp.asarray, args), cache, 0 if cache else None)
    want = np.asarray(want)
    with torch.no_grad():
        got = model(torch.from_numpy(embeds), torch.from_numpy(pos), torch.from_numpy(mask),
                    tcache, 0).numpy()
    assert got.dtype == np.float32 and got.shape == (b, t, tcfg.vocab_size)
    d = np.abs(got - want)[rows]
    if bf16:
        assert d.max() <= TEXT_BF16_SHARE * np.abs(want[rows]).max(), d.max()
    else:
        assert d.max() <= TEXT_F32_TOL, d.max()


def _generate_both(text, eos, max_new=24):
    from facet_tpu.models import qwen_text as jt
    from facet_tpu_torch.models import qwen_text as tt

    jcfg, tcfg, params = text
    ids, _, valid = _batch(seed=1, t=11)
    embeds = np.asarray(jt.embed_tokens(params, jnp.asarray(ids)), np.float32)
    pos, next_pos = jt.rope_index_batch(ids, valid, np.zeros((0, 3)), -1)
    eos = np.asarray(sorted(eos), np.int32)
    want = jt.QwenTextDecoder(params, jcfg, max_new_tokens=max_new).generate(
        embeds, valid, pos, next_pos, eos)
    decoder = tt.QwenTextDecoder(_port_text(tcfg, params), max_new)
    got = decoder.generate(torch.from_numpy(embeds), valid, pos, next_pos, eos)
    return want, got, (decoder, embeds, valid, pos, next_pos)


def test_cached_decode_matches_full_forward(text):
    """Each greedy token of the cached decode is the argmax of the
    cache-less forward over the prompt and the tokens before it."""
    _, got, (decoder, embeds, valid, pos, next_pos) = _generate_both(text, [255])
    model = decoder.model
    b, t, _ = embeds.shape
    n = got.shape[1]
    with torch.no_grad():
        full = torch.cat([torch.from_numpy(embeds),
                          model.embed_tokens(torch.from_numpy(got[:, :-1])).float()], 1)
        gen_pos = next_pos[None, :, None] + np.arange(n - 1)[None, None, :]
        all_pos = np.concatenate([pos, np.broadcast_to(gen_pos, (3, b, n - 1))], 2)
        keep = np.concatenate([valid, np.ones((b, n - 1), bool)], 1)
        mask = np.tril(np.ones((t + n - 1,) * 2, bool))[None] & keep[:, None, :]
        logits = model(full, torch.from_numpy(all_pos), torch.from_numpy(mask)).numpy()
    last = np.where(valid, np.arange(t), -1).max(1)
    for i in range(b):
        steps = np.concatenate([[last[i]], t + np.arange(n - 1)])
        np.testing.assert_array_equal(logits[i, steps].argmax(-1), got[i])


@pytest.mark.parametrize("stop", ["one_row", "all_rows"])
def test_greedy_tokens_identical_f32(text, stop):
    """Greedy tokens at float32 equal the JAX decoder's, with a left- and a
    right-padded row: one row stopping early on an EOS id (the other runs
    to the end), or both (the port's loop then ends early and fills)."""
    free, _, _ = _generate_both(text, [255])
    row0 = [int(x) for x in free[0, 1:6] if x not in free[1]]
    eos = [row0[0]] if stop == "one_row" else [int(free[0, 2]), int(free[1, 3])]
    want, got, _ = _generate_both(text, eos)
    np.testing.assert_array_equal(got, want)
    done = [bool(np.isin(row, eos).any()) for row in got]
    assert done == [True, stop == "all_rows"]
    if stop == "all_rows":
        assert (got[:, -1] == min(eos)).all()


def test_rope_index_batch_identical():
    """3D rope positions of padded rows holding images, as the JAX package
    computes them: left- and right-padded rows, two images in one row,
    images consumed in order across the batch."""
    from facet_tpu.models import qwen_text as jt
    from facet_tpu_torch.models import qwen_text as tt

    img, pad = 77, 0
    row0 = [1, 2] + [img] * 6 + [3, 4, 5]                    # grid (1, 4, 6)
    row1 = [6] + [img] * 4 + [7] + [img] * 2 + [8, 9]        # (1, 4, 4), (1, 2, 4)
    row2 = [img] * 4 + [10]                                  # (1, 4, 4)
    t = 14
    ids = np.array([[pad] * (t - len(row0)) + row0, row1 + [pad] * (t - len(row1)),
                    [pad] * (t - len(row2)) + row2])
    valid = np.array([[False] * (t - len(row0)) + [True] * len(row0),
                      [True] * len(row1) + [False] * (t - len(row1)),
                      [False] * (t - len(row2)) + [True] * len(row2)])
    grids = np.array([[1, 4, 6], [1, 4, 4], [1, 2, 4], [1, 4, 4]])
    want = jt.rope_index_batch(ids, valid, grids, img)
    got = tt.rope_index_batch(ids, valid, grids, img)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tt.text_rope_index(ids, None), jt.text_rope_index(ids, None)):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------------- vision tower


def _vision(seed=2):
    from facet_tpu.models import qwen_vision as jv
    from facet_tpu_torch.models import qwen_vision as tv

    jcfg = jv.QwenVisionConfig(**TINY_VISION)
    x = np.random.default_rng(4).standard_normal((64, jcfg.patch_dim)).astype(np.float32)
    tree = jax.tree.map(np.asarray, jax.jit(jv.QwenVisionTower(jcfg, 8, 8).init)(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    tower = P.bridge(tv.QwenVisionTower(tv.QwenVisionConfig(**TINY_VISION), "cpu"), tree)
    return jcfg, tree, tower


@pytest.fixture(scope="module")
def vision():
    return _vision()


@pytest.mark.parametrize("grid", [(8, 8), (6, 10)], ids=["whole_windows", "padded_windows"])
def test_vision_tower(vision, grid):
    from facet_tpu.models import qwen_vision as jv

    jcfg, tree, tower = vision
    gh, gw = grid
    x = np.random.default_rng(gh).standard_normal((gh * gw, jcfg.patch_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jv.QwenVisionTower(jcfg, gh, gw).apply)(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tower(torch.from_numpy(x), gh, gw).numpy()
    assert got.shape == (gh * gw // 4, jcfg.out_hidden_size)
    np.testing.assert_allclose(got, want, atol=VISION_TOL, rtol=0)
    lay = jv.window_layout(jcfg, gh, gw)
    assert bool(lay["valid"].all()) == (grid == (8, 8))


def test_vision_encode_two_images(vision):
    from facet_tpu.models import qwen_vision as jv
    from facet_tpu_torch.models.qwen_vision import QwenVisionEncoder

    jcfg, tree, tower = vision
    grids = [(1, 8, 8), (1, 6, 10)]
    x = np.random.default_rng(9).standard_normal((124, jcfg.patch_dim)).astype(np.float32)
    want = jv.QwenVisionEncoder(tree, jcfg).encode(x, grids)
    got = QwenVisionEncoder(tower).encode(x, grids)
    assert got.shape == (31, jcfg.out_hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=VISION_TOL, rtol=0)


# --------------------------------------------------------------- the tagger


def _vocabulary():
    from facet_tpu_torch.config.default_config import build_default_config
    from facet_tpu_torch.config.scoring_config import ScoringConfig

    config = ScoringConfig.__new__(ScoringConfig)
    config.config = build_default_config()
    return sorted(config.get_tag_vocabulary())


def _processor():
    from chip_smoke import StandInProcessor

    return StandInProcessor(_vocabulary(), specials=TINY_SPECIALS, n_text=250, **TINY_PIXELS)


@pytest.fixture(scope="module")
def stacks(text, vision):
    """(jax (encoder, decoder), port (encoder, decoder)) of the tiny tagger,
    with the same parameters, generating MAX_NEW tokens at float32."""
    from facet_tpu.models import qwen_text as jt
    from facet_tpu.models import qwen_vision as jv
    from facet_tpu_torch.models.qwen_text import QwenTextDecoder
    from facet_tpu_torch.models.qwen_vision import QwenVisionEncoder

    jcfg, tcfg, params = text
    vcfg, tree, tower = vision
    return ((jv.QwenVisionEncoder(tree, vcfg), jt.QwenTextDecoder(params, jcfg, max_new_tokens=MAX_NEW)),
            (QwenVisionEncoder(tower), QwenTextDecoder(_port_text(tcfg, params), MAX_NEW)))


def test_standin_processor_matches_transformers(monkeypatch):
    """The stand-in's image half equals transformers' Qwen2VLImageProcessor
    at the published settings: the smart_resize grid and every value of
    the cell-major patch rows."""
    from PIL import Image

    monkeypatch.setenv("USE_TF", "0")      # transformers need not load TensorFlow
    from transformers import Qwen2VLImageProcessor

    from chip_smoke import QWEN_MAX_PIXELS, QWEN_MIN_PIXELS, StandInProcessor

    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (61, 90, 3), np.uint8))
    want = Qwen2VLImageProcessor(min_pixels=QWEN_MIN_PIXELS, max_pixels=QWEN_MAX_PIXELS)(
        images=[img], return_tensors="np")
    patches, grid = StandInProcessor(["tag"]).preprocess(img)
    np.testing.assert_array_equal(want["image_grid_thw"], [grid])
    np.testing.assert_array_equal(patches, want["pixel_values"])


def test_device_generate_identical(stacks):
    """Both packages' device_generate through the stand-in processor on two
    images of different sizes (the shorter prompt left-padded): identical
    replies and tag lists."""
    from PIL import Image

    from facet_tpu.models import vlm_tagger as jtag
    from facet_tpu_torch.models import vlm_tagger as ttag

    rng = np.random.default_rng(3)
    pils = [Image.fromarray(rng.integers(0, 256, shape, np.uint8))
            for shape in ((40, 56, 3), (24, 40, 3))]
    processor = _processor()
    prompt = "Look at this photo and list the matching tags. Reply with only the tags."
    (jenc, jdec), (tenc, tdec) = stacks
    want = jtag.device_generate(processor, jenc, jdec, pils, prompt)
    got = ttag.device_generate(processor, tenc, tdec, pils, prompt)
    assert got == want and all(got)
    vocab = processor.tokenizer.vocabulary
    assert [ttag.parse_tag_output(r, vocab) for r in got] == [
        jtag.parse_tag_output(r, vocab) for r in want]
    inputs = processor(text=["<|image_pad|>"] * 2, images=pils)
    assert inputs["attention_mask"][0].all() and not inputs["attention_mask"][1].all()


@pytest.mark.parametrize("text_in", [
    "landscape, Portraits;  beach\nsunset, landscape, xyz", "", "bokeh,,aerail, anmal, city",
    "a, b, c, d, e, f, g"])
def test_reply_parsing_identical(text_in):
    """The port's copies of levenshtein, snap_to_vocabulary and
    parse_tag_output give the JAX package's tags."""
    from facet_tpu.models import vlm_tagger as jtag
    from facet_tpu_torch.models import vlm_tagger as ttag

    vocab = _vocabulary()
    assert ttag.parse_tag_output(text_in, vocab, 3) == jtag.parse_tag_output(text_in, vocab, 3)
    for word in text_in.split(","):
        assert ttag.snap_to_vocabulary(word, vocab) == jtag.snap_to_vocabulary(word, vocab)
        assert ttag.levenshtein(word, "landscape") == jtag.levenshtein(word, "landscape")


# -------------------------------------------------- the chain and the scans


def _configs(root, profile="24gb"):
    """(port config path, JAX config path) with the tiny CLIP and ``profile``."""
    from test_torch_slice import TINY_ARCH

    from facet_tpu_torch.config.default_config import write_default_config

    path = root / f"scoring_config_{profile}.json"
    write_default_config(str(path))
    cfg = json.loads(path.read_text())
    cfg["models"]["clip"]["architecture"] = TINY_ARCH
    cfg["models"]["vram_profile"] = profile
    path.write_text(json.dumps(cfg))
    return str(path)


def test_chain_unavailable_lines_match_jax(tmp_path, capsys, monkeypatch):
    """With no tagger installed, both packages walk vlm_tagger ->
    qwen3_vl_tagger -> ram_tagger, each raising its RuntimeError, and print
    the same three lines; nothing is left to tag with but CLIP."""
    from facet_tpu.config.scoring_config import ScoringConfig as JConfig
    from facet_tpu.processing.multi_pass import ChunkedMultiPassProcessor as JProcessor
    from facet_tpu.processing.scorer import Facet as JFacet
    from facet_tpu_torch.config.scoring_config import ScoringConfig
    from facet_tpu_torch.processing.multi_pass import ChunkedMultiPassProcessor
    from facet_tpu_torch.processing.scorer import Facet

    monkeypatch.chdir(tmp_path)
    cfg = _configs(tmp_path)
    lines = []
    for processor in (JProcessor(JFacet(str(tmp_path / "j.db"), JConfig(cfg))),
                      ChunkedMultiPassProcessor(Facet(str(tmp_path / "t.db"), ScoringConfig(cfg),
                                                      device="cpu"))):
        assert processor._load_with_fallback("vlm_tagger") == (None, None)
        lines.append(capsys.readouterr().out.splitlines())
    assert lines[0] == lines[1] and len(lines[1]) == 3
    assert "VLM tagger unavailable" in lines[1][0] and "RAM++" in lines[1][2]


REFUSALS = {
    "qwen3_dir": ("Qwen/Qwen3-VL-2B-Instruct", "Qwen3-VL"),
    "ram_npz": ("pretrained/ram_plus.npz", "RAM++"),
    "ram_dir": ("xinyu1205/recognize-anything-plus-model", "RAM++"),
    "qwen25_dir_without_npz": ("Qwen/Qwen2.5-VL-7B-Instruct", "qwen25_text.npz"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_refuses_unported_tagger(tmp_path, capsys, monkeypatch, case):
    """An installed tagger the port cannot run, first in the chain that
    would load, makes the 24gb scan exit 2 naming it before any row."""
    from PIL import Image

    from facet_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(P, "PRETRAINED_DIR", str(tmp_path / "pretrained"))
    (tmp_path / "pretrained").mkdir()
    (tmp_path / "photos").mkdir()
    Image.fromarray(np.zeros((40, 48, 3), np.uint8)).save(tmp_path / "photos" / "a.jpg")
    path, named = REFUSALS[case]
    if path.endswith(".npz"):
        (tmp_path / path).write_bytes(b"")
        (tmp_path / "pretrained" / "ram_tag_list.txt").write_text("cat\n")
    else:
        (tmp_path / path).mkdir(parents=True)
    db = tmp_path / "x.db"
    rc = main(["photos", "--db", str(db), "--config", _configs(tmp_path), "--device", "cpu"])
    assert rc == 2
    assert named in capsys.readouterr().err
    assert sqlite3.connect(db).execute("SELECT COUNT(*) FROM photos").fetchone()[0] == 0


@pytest.fixture(scope="module")
def scans24(tmp_path_factory, stacks):
    """The default scan under the "24gb" profile, with the tiny tagger:
    facet_tpu's processor, its ModelManager._factories patched (the tagger
    installed; TOPIQ, SAMP-Net and the faces member left out, unavailable,
    so that its fused CLIP pass is all it compiles besides the tagger), and
    ``python -m facet_tpu_torch --device cpu`` with the small members of
    tests/test_torch_slice.py registered; then the port's scan without a
    tagger -> (jax rows, port rows, port rows without a tagger, what that
    scan printed, the config)."""
    from PIL import Image
    from test_torch_slice import DET_SIZE, _member_trees, _rows

    root = tmp_path_factory.mktemp("scan24")
    photo_dir = root / "photos"
    photo_dir.mkdir()
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:72, 0:96]
    for i in range(2):
        img = rng.uniform(0, 255, 3) + 0.8 * xx[..., None] + rng.normal(0, 20, (72, 96, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(photo_dir / f"p{i}.jpg")
    files = sorted(str(p) for p in photo_dir.iterdir())
    cfg = _configs(root)
    processor = _processor()
    (jenc, jdec), (tenc, tdec) = stacks
    trees = _member_trees()
    faces, samp = trees["insightface"], trees["samp_net"]
    mp = pytest.MonkeyPatch()
    mp.setenv("FACET_DISABLE_DP", "1")
    mp.chdir(root)          # no pretrained_models/ here: nothing installed
    try:
        from facet_tpu.config.scoring_config import ScoringConfig as JConfig
        from facet_tpu.models.vlm_tagger import VLMTagger as JTagger
        from facet_tpu.processing.multi_pass import ChunkedMultiPassProcessor as JProcessor
        from facet_tpu.processing.scorer import Facet as JFacet
        from facet_tpu_torch.__main__ import main
        from facet_tpu_torch.models import face_models, samp_net, scrfd, u2netp
        from facet_tpu_torch.models import topiq as ttopiq
        from facet_tpu_torch.models.face_pipeline import FacePipeline
        from facet_tpu_torch.models.model_manager import ModelManager
        from facet_tpu_torch.models.vlm_tagger import VLMTagger

        def absent(config, cached):
            raise RuntimeError("left out of this scan")

        jconfig = JConfig(cfg)
        jtagger = JTagger(jconfig, model_name="qwen2.5-vl-7b")
        jtagger._device, jtagger._processor = (jenc, jdec), processor
        jfacet = JFacet(str(root / "jax.db"), jconfig)
        # the reference for the tags column: CLIP and the tagger; the other
        # members drop out as unavailable, which leaves the tags as they are
        for name in ("topiq", "clipiqa", "samp_net", "insightface"):
            jfacet.models._factories[name] = absent
        jfacet.models._factories["vlm_tagger"] = lambda c, _: jtagger
        JProcessor(jfacet).process_directory(files, verbose=False)

        makers = {
            "topiq": lambda c: ttopiq.TOPIQScorer(P.fallback_init(
                ttopiq.TOPIQNet(ttopiq.TOPIQConfig(input_size=128)), seed=30), "cpu"),
            "samp_net": lambda c: samp_net.SAMPComposition(
                P.bridge(samp_net.SAMPNet(), samp[0]), P.bridge(u2netp.U2NETP(), samp[1]),
                "cpu"),
            "insightface": lambda c: FacePipeline(
                P.bridge(scrfd.SCRFD(scrfd.SCRFDConfig(input_size=DET_SIZE)), faces[0]),
                P.bridge(face_models.LandmarkNet(), faces[1]),
                P.bridge(face_models.IResNet(), faces[2]), "cpu", c),
            "vlm_tagger": lambda c: VLMTagger(c, device="cpu").install(processor, tenc, tdec)}
        built = {}      # each member built once, for both scans

        def member(name):
            def factory(config, cached):
                if name not in built:
                    built[name] = makers[name](config)
                return built[name]
            return factory

        def members(defaults, tagger):
            def register(manager):
                defaults(manager)
                for name in makers:
                    if tagger or name != "vlm_tagger":
                        manager.register(name, member(name))
            return register

        original = ModelManager._register_default_factories
        out = {}
        for db, tagger in (("torch.db", True), ("torch_clip.db", False)):
            mp.setattr(ModelManager, "_register_default_factories", members(original, tagger))
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = main([str(photo_dir), "--db", str(root / db), "--config", cfg,
                           "--device", "cpu"])
            assert rc == 0, printed.getvalue()[-3000:]
            out[db] = (_rows(str(root / db)), printed.getvalue())
        yield (_rows(str(root / "jax.db")), out["torch.db"][0], *out["torch_clip.db"], cfg)
    finally:
        mp.undo()


def test_scan_24gb_tags_match_jax(scans24):
    """With the tiny tagger registered in both packages, the 24gb scan
    writes facet_tpu's tags column, and tags differ from CLIP's."""
    want, got, clip_rows, _, _ = scans24
    assert [r["path"] for r in got] == [r["path"] for r in want]
    assert [r["tags"] for r in got] == [r["tags"] for r in want]
    assert all(r["tags"] for r in got)
    assert [r["tags"] for r in got] != [r["tags"] for r in clip_rows]


def test_scan_24gb_without_tagger_writes_clip_tags(scans24):
    """With nothing installed the chain prints its three "unavailable"
    lines and the scan tags with CLIP: each row's tags are CLIP's tags of
    its stored embedding, and every other column equals the scan's with
    the tagger, apart from the category (and so the aggregate) that the
    tags route."""
    from facet_tpu_torch.config.scoring_config import ScoringConfig
    from facet_tpu_torch.processing.scorer import Facet
    from facet_tpu_torch.utils.tags import tags_to_string

    _, tagged, rows, printed, cfg = scans24
    lines = [ln.strip() for ln in printed.splitlines() if "unavailable" in ln]
    assert [ln.split(":")[0] for ln in lines] == [
        "pass vlm_tagger", "pass qwen3_vl_tagger", "pass ram_tagger"], lines
    assert lines[0].endswith("; trying qwen3_vl_tagger") and lines[2].endswith("; skipping")
    tagger = Facet(":memory:", ScoringConfig(cfg), device="cpu").tagger
    clip = tagger.tag_embedding_bytes([r["clip_embedding"] for r in rows])
    assert [r["tags"] for r in rows] == [tags_to_string(t) for t in clip]
    routed = ("tags", "category", "aggregate")     # the category follows the tags
    for row, other in zip(rows, tagged):
        assert {k: v for k, v in row.items() if k not in routed} == {
            k: v for k, v in other.items() if k not in routed}
