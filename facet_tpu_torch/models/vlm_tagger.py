"""VLM tagging: the Qwen2.5-VL-7B tagger on the card.

Counterpart of ``facet_tpu/models/vlm_tagger.py``: the prompt built from
the config's tag vocabulary, sub-batched generation that falls back to
batch 1 on an out-of-memory error and skips a batch on any other runtime
failure (counted in ``skipped_batches``, and printed), and the reply parsed
with Levenshtein snapping (distance <= 2) onto the vocabulary.

The port runs the JAX package's path 1, all on the device: the vision
tower (``models/qwen_vision.py``) and the text decoder
(``models/qwen_text.py``, bf16 weights, a static KV cache, greedy decode)
when both converted checkpoints are installed
(``pretrained_models/qwen25_text.npz`` and ``qwen25_vision.npz``); only the
tokenizer and image processor (``transformers.AutoProcessor``, imported
only then) stay on the host. One H100 holds the whole decoder, so there is
no tensor-parallel mesh.

``probe()`` is the JAX package's availability check, word for word where
nothing is installed (a missing model directory raises ``RuntimeError``
before anything is imported, and the fallback chain goes on). What the port
cannot run yet raises ``NotImplementedError`` naming what is installed: a
Qwen3-VL model directory, and the Qwen2.5 directory without the two
converted checkpoints (the JAX package would load it with host
``transformers``, its paths 2 and 3). ``probe_ram`` does the same for the
RAM++ tagger, which is not ported. A device path that is installed but
fails to load raises ``RuntimeError``, and the chain goes on (the JAX
package would try host ``transformers`` next).
"""

import os

import numpy as np
import torch

from facet_tpu_torch import params as P
from facet_tpu_torch.models.model_manager import resolve_device

CHECKPOINTS = ("qwen25_text", "qwen25_vision")


def levenshtein(a, b, cap=3):
    """Edit distance with an early-exit cap."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = cur[0]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
            best = min(best, cur[j])
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]


def snap_to_vocabulary(word, vocabulary, max_distance=2):
    """Snap a generated word onto the nearest vocabulary tag, or None."""
    word = word.strip().lower()
    if not word:
        return None
    if word in vocabulary:
        return word
    best, best_d = None, max_distance + 1
    for tag in vocabulary:
        d = levenshtein(word, tag, cap=max_distance)
        if d < best_d:
            best, best_d = tag, d
    return best if best_d <= max_distance else None


def parse_tag_output(text, vocabulary, max_tags=5):
    """Model output -> deduplicated list of vocabulary tags."""
    for sep in ("\n", ";"):
        text = text.replace(sep, ",")
    seen, out = set(), []
    for part in text.split(","):
        tag = snap_to_vocabulary(part, vocabulary)
        if tag and tag not in seen:
            seen.add(tag)
            out.append(tag)
            if len(out) >= max_tags:
                break
    return out


def device_generate(processor, encoder, decoder, pil_images, prompt):
    """Host tokenization -> vision encode -> token and vision embeddings
    merged -> KV-cache greedy decode -> reply strings, all model work on
    the decoder's device."""
    embeds, valid, pos, next_pos, eos_ids = prepare_inputs(
        processor, encoder, decoder, pil_images, prompt)
    out = decoder.generate(embeds, valid, pos, next_pos, eos_ids)
    replies = []
    for row in out:
        stop = np.nonzero(np.isin(row, eos_ids))[0]
        end = int(stop[0]) if len(stop) else len(row)
        replies.append(processor.tokenizer.decode(row[:end], skip_special_tokens=True))
    return replies


def prepare_inputs(processor, encoder, decoder, pil_images, prompt):
    """The decoder's inputs for one batch of images: (embeds (B, T, E)
    float32 on the device, valid (B, T), position_ids (3, B, T), next_pos
    (B,), eos_ids sorted). The prompt length is padded to a multiple of 64,
    as the JAX package buckets it."""
    from facet_tpu_torch.models.qwen_text import rope_index_batch

    messages = [[{"role": "user",
                  "content": [{"type": "image"}, {"type": "text", "text": prompt}]}]
                for _ in pil_images]
    texts = [processor.apply_chat_template(m, tokenize=False, add_generation_prompt=True)
             for m in messages]
    inputs = processor(text=texts, images=list(pil_images), return_tensors="np",
                       padding=True)
    ids = np.asarray(inputs["input_ids"])
    valid = np.asarray(inputs["attention_mask"]).astype(bool)
    grid_thw = np.asarray(inputs["image_grid_thw"])

    bucket = -(-ids.shape[1] // 64) * 64
    if bucket != ids.shape[1]:
        extra = bucket - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, extra)))
        valid = np.pad(valid, ((0, 0), (0, extra)))

    vis = encoder.encode(np.asarray(inputs["pixel_values"], np.float32), grid_thw.tolist())
    # token embeddings in float32 (the table's dtype values), as the JAX
    # package hands them to its decoder; vision rows replace the image pads
    embeds = decoder.model.embed_tokens(
        torch.as_tensor(ids, device=decoder.device)).to(torch.float32)
    image_token_id = getattr(processor, "image_token_id", None) \
        or processor.tokenizer.convert_tokens_to_ids("<|image_pad|>")
    slots = np.nonzero(ids == image_token_id)
    embeds[torch.as_tensor(slots[0]), torch.as_tensor(slots[1])] = \
        vis[:len(slots[0])].to(embeds.device)

    pos, next_pos = rope_index_batch(ids, valid, grid_thw, image_token_id)
    tok = processor.tokenizer
    eos = {tok.eos_token_id}
    im_end = tok.convert_tokens_to_ids("<|im_end|>")
    if im_end is not None and im_end >= 0:
        eos.add(im_end)
    return embeds, valid, pos, next_pos, np.asarray(sorted(eos), np.int64)


def probe_ram(config):
    """The RAM++ tagger's availability check: RuntimeError (the JAX
    package's message) when neither its converted checkpoint with its tag
    list nor its model directory is installed; NotImplementedError when one
    is, since the port does not run RAM++ yet."""
    settings = config.get_model_config().get("ram_plus", {})
    model_path = settings.get("model_path", "xinyu1205/recognize-anything-plus-model")
    converted = [os.path.join(P.PRETRAINED_DIR, f)
                 for f in ("ram_plus.npz", "ram_tag_list.txt")]
    if all(os.path.exists(f) for f in converted) or os.path.isdir(model_path):
        found = converted if all(os.path.exists(f) for f in converted) else [model_path]
        raise NotImplementedError(
            f"the RAM++ tagger is installed ({', '.join(found)}), and facet_tpu_torch "
            f"does not run it yet (ROADMAP.md Queue 1 #9.3.2, RAM++); remove it "
            f"to tag with the chain's next member, or use photos.py")
    raise RuntimeError(
        f"RAM++ tagger unavailable: no converted ram_plus.npz and"
        f" {model_path} is not a local model directory; the tagging fallback"
        " chain continues")


class VLMTagger:
    """Qwen-VL tagger; the family comes from the model name."""

    def __init__(self, config, model_name=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        models = config.get_model_config()
        self.model_name = model_name or "qwen2.5-vl-7b"
        key = "qwen2_5_vl_7b" if "2.5" in self.model_name else "qwen3_vl_2b"
        settings = models.get(key, {})
        self.model_path = settings.get("model_path", "Qwen/Qwen2.5-VL-7B-Instruct")
        self.batch_size = settings.get("vlm_batch_size", 2)
        self.max_new_tokens = settings.get("max_new_tokens", 100)
        self.vocabulary = sorted(config.get_tag_vocabulary().keys())
        self.max_tags = config.get_tagging_settings().get("max_tags", 5)
        self.skipped_batches = 0
        self._processor = None
        self._device = None   # (QwenVisionEncoder, QwenTextDecoder) once loaded

    # ------------------------------------------------------------- loading

    def probe(self):
        """Raise unless the device path can load: RuntimeError when the
        model directory is missing (the JAX package's check, before any
        import), NotImplementedError for what the port cannot run yet."""
        if not os.path.isdir(self.model_path):
            raise RuntimeError(
                f"VLM tagger unavailable: {self.model_path} is not a local"
                " model directory; the profile falls back to CLIP tagging")
        if "2.5" not in self.model_name:
            raise NotImplementedError(
                f"the Qwen3-VL tagger is installed ({self.model_path}), and "
                f"facet_tpu_torch does not run it yet (ROADMAP.md Queue 1 #9.3.1, "
                f"Qwen3-VL-2B); remove it to tag with the chain's next member, or "
                f"use photos.py")
        missing = [os.path.join(P.PRETRAINED_DIR, f"{name}.npz") for name in CHECKPOINTS
                   if not os.path.exists(os.path.join(P.PRETRAINED_DIR, f"{name}.npz"))]
        if missing:
            raise NotImplementedError(
                f"{self.model_path} is installed without {', '.join(missing)}: the JAX "
                f"package would tag through host transformers, which facet_tpu_torch "
                f"does not run (ROADMAP.md Queue 1 #9.3.4, host-transformers paths); "
                f"convert the checkpoints (tools/convert_checkpoints.py) "
                f"or use photos.py")
        return True

    def ensure_loaded(self):
        if self._device is not None:
            return True
        self.probe()
        try:
            self._load_device_path()
        except Exception as exc:
            raise RuntimeError(f"VLM tagger unavailable: the device path of "
                               f"{self.model_path} did not load ({exc!r})") from exc
        return True

    def _load_device_path(self):
        """The vision tower (float32) and the text decoder (bf16) from the
        converted checkpoints, on this tagger's device."""
        from transformers import AutoProcessor

        from facet_tpu_torch.models.qwen_text import (
            QwenTextConfig, QwenTextDecoder, QwenTextModel)
        from facet_tpu_torch.models.qwen_vision import QwenVisionEncoder

        encoder = QwenVisionEncoder.load(self.device)
        model = P.bridge(QwenTextModel(QwenTextConfig(), torch.bfloat16, self.device),
                         P.load_npz("qwen25_text"))
        processor = AutoProcessor.from_pretrained(self.model_path, local_files_only=True)
        self.install(processor, encoder, QwenTextDecoder(model, self.max_new_tokens))
        print(f"VLM tagger: device path on {self.device} (vision tower + text decoder)")

    def install(self, processor, encoder, decoder):
        """Use ``encoder`` and ``decoder`` (on this tagger's device) with
        ``processor``: the converted checkpoints' path, and how tests and
        the smoke install a tagger of their own."""
        self._processor = processor
        self._device = (encoder, decoder)
        return self

    def build_prompt(self):
        vocab = ", ".join(self.vocabulary)
        return ("Look at this photo and list the matching tags from this exact"
                f" vocabulary (comma separated, at most {self.max_tags}):"
                f" {vocab}. Reply with only the tags.")

    # ------------------------------------------------------------- tagging

    def tag_batch(self, pil_images):
        """PIL images -> list of tag lists, sub-batched: an out-of-memory
        error retries at batch 1, any other runtime failure skips the batch
        (empty tag lists), counted in skipped_batches."""
        self.ensure_loaded()
        results = []
        pos = 0
        batch = self.batch_size
        while pos < len(pil_images):
            chunk = pil_images[pos:pos + batch]
            try:
                results.extend(self._generate_device(chunk))
                pos += len(chunk)
            except RuntimeError as exc:
                if "out of memory" in str(exc).lower() and batch > 1:
                    batch = 1
                    if self.device.type == "cuda":
                        torch.cuda.empty_cache()
                    continue
                self.skipped_batches += 1
                print(f"VLM tagger: skipped a batch of {len(chunk)} ({exc})")
                results.extend([[] for _ in chunk])
                pos += len(chunk)
        return results

    def _generate_device(self, chunk):
        encoder, decoder = self._device
        replies = device_generate(self._processor, encoder, decoder, list(chunk),
                                  self.build_prompt())
        return [parse_tag_output(reply, self.vocabulary, self.max_tags) for reply in replies]
