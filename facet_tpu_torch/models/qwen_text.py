"""Qwen2.5-VL text decoder in PyTorch with a static KV cache and greedy
generate.

Counterpart of ``facet_tpu/models/qwen_text.py`` (``QwenTextModel``,
``QwenTextDecoder``, ``text_rope_index``, ``rope_index_batch``): GQA
attention (28 query heads over 4 kv heads at 7B) with q/k/v biases and a
bias-free o_proj, multimodal 3D rope whose three position streams merge
along the head dim by ``mrope_section``, RMSNorm, SwiGLU MLP.

The JAX module's rounding points are kept where ``dtype`` is bfloat16 (the
tagger's, every leaf cast to bf16 as the JAX package casts it):

- the rope tables are computed in float32 and rounded to ``dtype``; rope
  runs in float32 on q and k with those tables and rounds back;
- RMSNorm takes its variance in float32, rounds the normalized value to
  the input's dtype, then multiplies by ``scale`` (bf16 by bf16);
- scores and P V are einsums in the promoted dtype of q and the keys:
  bf16 in the cache-less forward, float32 in generation, whose cache
  holds float32 (the JAX decoder allocates it in the dtype of the float32
  prompt embeddings), so q, k and v keep their bf16 values there; the scale
  ``hd**-0.5`` is rounded to the scores' dtype first (a weak-typed scalar in
  JAX), masked slots take -1e30, the softmax runs in float32 and its
  weights round to ``dtype``; query head ``h`` reads kv head
  ``h // (num_heads // num_kv_heads)``;
- each Dense adds its bias to the rounded product, as flax's Dense does;
- the logits come out in float32 (rounded to ``dtype`` first).

q, k and v share one weight tensor (rows q | k | v), and so do gate and up
(rows gate | up): one matmul each, with the flax leaves mapped onto views
of the shared tensors (``flax_layout``). Scores and P V of float32 inputs
that hold bf16 values run with TF32 allowed (``ops/precision.py``): bf16
values pass TF32's rounding unchanged and their products are exact in the
float32 accumulator, so only the order of the sums differs.

Generation (``QwenTextDecoder.generate``) is the JAX program's:
one cache of (B, kv_heads, prompt_len + max_new, head_dim) per layer on
the device (the JAX program's (B, len, kv_heads, head_dim), transposed so
that its batch and head dims flatten without a copy), in the dtype of the
prompt embeddings; prefill causal within the prompt with padding masked out (its
attention spans the prompt's columns only: the JAX program's other columns
are masked, and their weights are exactly zero); the next-token logits
from the last valid slot (``max(where(valid, arange, -1))``, for left and
right padding), the head run on that slot alone; greedy steps at one
position for all three streams, each attending over every slot of the
cache as the JAX program's do (the slots not yet written are masked), so
that a step has static shapes and inputs and on the card runs as one CUDA
graph replay (the cache and the graph are kept for the last batch shape,
and the cache is zeroed for each call); a row that has emitted an EOS id is done, emits
``eos_ids[0]`` from then on, and its slot is invalid except to itself. The JAX program always runs ``max_new - 1`` steps; this loop stops
when every row is done (it reads that on the host every
``DONE_CHECK_EVERY`` steps, not every token) and fills the rest with
``eos_ids[0]``, which is what those steps would have emitted.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facet_tpu_torch import params as P
from facet_tpu_torch.ops.precision import tf32_matmul

# generation reads "every row is done" on the host once per this many steps
DONE_CHECK_EVERY = 16


@dataclass(frozen=True)
class QwenTextConfig:
    # Qwen2.5-VL-7B language model; tests override with tiny dims
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: tuple = (16, 24, 24)
    tie_word_embeddings: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def rope_columns(config, device=None):
    """Per column of the merged rope table: the position stream it reads
    (its mrope section's, x2 halves) and its float32 frequency (column c's
    is that of c mod head_dim/2) -> (stream (hd,) int64, freq (hd,))."""
    hd = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    sections = list(config.mrope_section) * 2
    stream = np.repeat(np.arange(len(sections)) % 3, sections)
    return (torch.as_tensor(stream, device=device),
            torch.as_tensor(np.concatenate([inv_freq, inv_freq]), dtype=torch.float32,
                            device=device))


def mrope_cos_sin(position_ids, config, dtype=torch.float32, columns=None):
    """(3, B, T) integer positions -> (B, T, head_dim) cos and sin with the
    three streams merged by mrope_section: float32 tables, rounded to
    ``dtype``. ``columns``: rope_columns on the positions' device."""
    stream, freq = columns or rope_columns(config, position_ids.device)
    pos = position_ids.to(torch.float32)[stream]                # (hd, B, T)
    emb = (pos * freq[:, None, None]).permute(1, 2, 0)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _scalar(value, dtype):
    """A Python scalar rounded to ``dtype``, as JAX rounds a weak-typed one."""
    return torch.tensor(value, dtype=dtype).item()


class RMSNorm(nn.Module):
    def __init__(self, dim, eps, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = P.frozen(dim, dtype=dtype, device=device)

    def forward(self, x):
        xf = x.to(torch.float32)
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale

    def flax_layout(self, path):
        return P.raw(path + ("scale",), self.scale)


class TextAttention(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.config = config
        self.dtype = dtype
        hd = config.head_dim
        self.sizes = (config.num_heads * hd, config.num_kv_heads * hd,
                      config.num_kv_heads * hd)
        self.qkv_weight = P.frozen(sum(self.sizes), config.hidden_size, dtype=dtype,
                                   device=device)
        self.qkv_bias = P.frozen(sum(self.sizes), dtype=dtype, device=device)
        self.o_weight = P.frozen(config.hidden_size, self.sizes[0], dtype=dtype,
                                 device=device)
        # hd**-0.5 in the scores' dtype: float32 over the cache, else dtype
        self.scale = {d: _scalar(config.head_dim ** -0.5, d) for d in (dtype, torch.float32)}

    def forward(self, x, cos, sin, mask, cache=None, index=0):
        """x: (B, T, E); cos/sin: (B, T, hd); mask: (B, T, S) bool of the
        attendable slots. cache: None (S = T) or (k, v) tensors of
        (B, KV, max_len, hd), written in place at slots [index, index + T)
        (index an int, or a tensor of the T slots, which a captured step
        reads from the device); the attention then spans the first S
        slots."""
        cfg = self.config
        hd = cfg.head_dim
        b, t, _ = x.shape
        qkv = F.linear(x, self.qkv_weight) + self.qkv_bias
        q, k, v = qkv.split(self.sizes, dim=-1)
        q = q.reshape(b, t, cfg.num_heads, hd)
        k = k.reshape(b, t, cfg.num_kv_heads, hd)
        v = v.reshape(b, t, cfg.num_kv_heads, hd)

        # rope in float32 with the rounded tables
        cq, sq = cos[:, :, None, :], sin[:, :, None, :]
        qf, kf = q.to(torch.float32), k.to(torch.float32)
        q = (qf * cq + _rotate_half(qf) * sq).to(self.dtype)
        k = (kf * cq + _rotate_half(kf) * sq).to(self.dtype)

        # keys and values as (B, KV, S, hd): the cache's layout, whose
        # (B, KV) batch flattens for the matmuls without a copy
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if cache is not None:
            k_cache, v_cache = cache
            slots = (index if isinstance(index, torch.Tensor)
                     else torch.arange(index, index + t, device=x.device))
            k_cache.index_copy_(2, slots, k.to(k_cache.dtype))
            v_cache.index_copy_(2, slots, v.to(v_cache.dtype))
            s = mask.shape[-1]
            k, v = k_cache[:, :, :s], v_cache[:, :, :s]

        groups = cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(b, t, cfg.num_kv_heads, groups, hd).to(k.dtype)
        with tf32_matmul(k.dtype == torch.float32 and self.dtype != torch.float32):
            scores = torch.einsum("btkgd,bksd->bkgts", qg, k) * self.scale[k.dtype]
            scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
            weights = torch.softmax(scores.to(torch.float32), dim=-1).to(self.dtype)
            out = torch.einsum("bkgts,bksd->btkgd", weights.to(v.dtype), v)
        out = out.reshape(b, t, cfg.num_heads * hd).to(self.dtype)
        return F.linear(out, self.o_weight)

    def flax_layout(self, path):
        nq, nk, _ = self.sizes
        w, bias = self.qkv_weight, self.qkv_bias
        return (P.kernel(path + ("q_proj",), w[:nq], bias[:nq])
                + P.kernel(path + ("k_proj",), w[nq:nq + nk], bias[nq:nq + nk])
                + P.kernel(path + ("v_proj",), w[nq + nk:], bias[nq + nk:])
                + P.kernel(path + ("o_proj",), self.o_weight))


class DecoderLayer(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        e, i = config.hidden_size, config.intermediate_size
        self.input_layernorm = RMSNorm(e, config.rms_norm_eps, dtype, device)
        self.self_attn = TextAttention(config, dtype, device)
        self.post_attention_layernorm = RMSNorm(e, config.rms_norm_eps, dtype, device)
        self.gate_up_weight = P.frozen(2 * i, e, dtype=dtype, device=device)
        self.down_weight = P.frozen(e, i, dtype=dtype, device=device)

    def forward(self, x, cos, sin, mask, cache=None, index=0):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, cache, index)
        gate, up = F.linear(self.post_attention_layernorm(x), self.gate_up_weight).chunk(2, -1)
        return x + F.linear(F.silu(gate) * up, self.down_weight)

    def flax_layout(self, path):
        i = self.down_weight.shape[1]
        return (self.input_layernorm.flax_layout(path + ("input_layernorm",))
                + self.self_attn.flax_layout(path + ("self_attn",))
                + self.post_attention_layernorm.flax_layout(
                    path + ("post_attention_layernorm",))
                + P.kernel(path + ("gate_proj",), self.gate_up_weight[:i])
                + P.kernel(path + ("up_proj",), self.gate_up_weight[i:])
                + P.kernel(path + ("down_proj",), self.down_weight))


class QwenTextModel(nn.Module):
    """Decoder stack: prompt embeddings -> float32 logits. Parameters are
    held in ``dtype`` (bfloat16 on the tagger's path) on ``device``."""

    def __init__(self, config=QwenTextConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        e = config.hidden_size
        self.embed = P.frozen(config.vocab_size, e, dtype=dtype, device=device)
        self.layers = nn.ModuleList(DecoderLayer(config, dtype, device)
                                    for _ in range(config.num_layers))
        self.norm = RMSNorm(e, config.rms_norm_eps, dtype, device)
        self.lm_head = (None if config.tie_word_embeddings
                        else P.frozen(config.vocab_size, e, dtype=dtype, device=device))
        self.rope_columns = rope_columns(config, device)

    @property
    def device(self):
        return self.embed.device

    def embed_tokens(self, token_ids):
        return self.embed[token_ids]

    def forward(self, embeds, position_ids, mask, cache=None, index=0, last=None):
        """embeds: (B, T, E) (token and vision embeddings merged);
        position_ids: (3, B, T); mask: (B, T, S) attendable slots; cache:
        None or one (k, v) pair per layer, written in place at ``index``.
        -> (B, T, vocab) float32 logits, or with ``last`` (B,) the logits of
        those slots only, (B, 1, vocab)."""
        cos, sin = mrope_cos_sin(position_ids, self.config, self.dtype, self.rope_columns)
        x = embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, mask, None if cache is None else cache[i], index)
        if last is not None:
            x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        head = self.embed if self.lm_head is None else self.lm_head
        return F.linear(self.norm(x), head).to(torch.float32)

    def flax_layout(self):
        leaves = P.raw(("params", "embed_tokens", "embedding"), self.embed)
        for i, layer in enumerate(self.layers):
            leaves += layer.flax_layout(("params", f"layer{i}"))
        leaves += self.norm.flax_layout(("params", "norm"))
        if self.lm_head is not None:
            leaves += P.kernel(("params", "lm_head"), self.lm_head)
        return leaves


class _DecodeBuffers:
    """The KV cache of a batch of ``b`` rows over ``total`` slots and the
    decode step's static inputs; the step itself, captured in a CUDA graph
    on the card at its first use, reads them and writes the cache."""

    def __init__(self, model, b, total, dtype):
        cfg, dev = model.config, model.device
        self.cache = [tuple(torch.zeros((b, cfg.num_kv_heads, total, cfg.head_dim),
                                        dtype=dtype, device=dev) for _ in range(2))
                      for _ in range(cfg.num_layers)]
        self.tok = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.mask = torch.zeros((b, 1, total), dtype=torch.bool, device=dev)
        self._model = model
        self._run = None

    def _step(self):
        b = self.tok.shape[0]
        pos3 = self.pos.view(1, b, 1).expand(3, b, 1)
        logits = self._model(self._model.embed_tokens(self.tok)[:, None], pos3, self.mask,
                             self.cache, self.slot)
        return logits[:, 0].argmax(-1)

    def step(self):
        """One greedy step at the slot, mask, tokens and positions set in the
        buffers -> the next tokens (on the card, the graph's output tensor,
        refilled by every replay)."""
        if self._run is None:
            self._run = _graphed(self._step) if self.tok.is_cuda else self._step
        return self._run()


class QwenTextDecoder:
    """Greedy KV-cache generation over a QwenTextModel on its device. The
    cache and the captured decode step are kept for the last batch shape,
    so that batches of one prompt bucket replay one graph."""

    def __init__(self, model, max_new_tokens=96):
        self.model = model
        self.config = model.config
        self.max_new_tokens = max_new_tokens
        self._buffers = None     # ((b, total, dtype), _DecodeBuffers)

    @property
    def device(self):
        return self.model.device

    def _buffers_for(self, b, total, dtype):
        key = (b, total, dtype)
        if self._buffers is None or self._buffers[0] != key:
            self._buffers = None            # free the old cache before the new one
            self._buffers = (key, _DecodeBuffers(self.model, b, total, dtype))
        buffers = self._buffers[1]
        for k, v in buffers.cache:
            k.zero_()
            v.zero_()
        return buffers

    @torch.no_grad()
    def generate(self, embeds, valid, position_ids, next_pos, eos_ids):
        """embeds (B, T, E) float; valid (B, T) bool; position_ids (3, B, T);
        next_pos (B,) the first position of the generated tokens; eos_ids
        (n_eos,) sorted. Tensors or arrays; -> (B, max_new) int64 numpy
        token ids, eos-filled after each row's first EOS."""
        model, dev = self.model, self.device
        embeds = torch.as_tensor(embeds, device=dev)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        position_ids = torch.as_tensor(position_ids, dtype=torch.int64, device=dev)
        pos = torch.as_tensor(next_pos, dtype=torch.int64, device=dev)
        eos = torch.as_tensor(eos_ids, dtype=torch.int64, device=dev)
        b, t, _ = embeds.shape
        n_new = self.max_new_tokens
        buffers = self._buffers_for(b, t + n_new, embeds.dtype)
        slot_valid = torch.cat([valid, torch.zeros((b, n_new), dtype=torch.bool, device=dev)], 1)

        # prefill: causal within the prompt, padding masked out
        causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        pmask = causal[None] & valid[:, None, :]
        arange = torch.arange(t, device=dev)
        last = torch.where(valid, arange[None], -1).amax(1).clamp_min(0)
        logits = model(embeds, position_ids, pmask, buffers.cache, 0, last=last)[:, 0]

        tok = logits.argmax(-1)
        done = torch.isin(tok, eos)
        out = torch.full((b, n_new), int(eos_ids[0]), dtype=torch.int64, device=dev)
        out[:, 0] = tok
        for i in range(n_new - 1):
            if i % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            # each step attends over every slot; those not yet valid are masked
            slot = t + i
            slot_valid[:, slot] = ~done
            buffers.mask.copy_(slot_valid[:, None])
            # the new slot attends to itself even when its row is done
            buffers.mask[:, :, slot] = True
            buffers.slot.fill_(slot)
            buffers.tok.copy_(tok)
            buffers.pos.copy_(pos)
            nxt = buffers.step()
            tok = torch.where(done, eos[0], nxt)
            done = done | torch.isin(nxt, eos)
            pos = pos + 1
            out[:, i + 1] = tok
        return out.cpu().numpy()


def _graphed(step):
    """``step`` captured once in a CUDA graph (after one warm-up call on a
    side stream, where cuBLAS picks its kernels) -> a callable that replays
    it and returns its output tensor, refilled by every replay. A decode
    step is some 1,600 small launches; replayed, the host launches one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()

    def replay():
        graph.replay()
        return out

    return replay


def text_rope_index(input_ids, image_spans, config_merge=2):
    """Host-side 3D rope positions for image+text rows (get_rope_index).

    input_ids: (B, T); image_spans: per row, list of (start, t, h, w), the
    index of the first image pad token and the grid BEFORE spatial merge.
    Text tokens advance all three streams together, continuing from
    max(previous) + 1; image tokens get constant t and raster h/w positions
    offset by the text cursor. -> position_ids (3, B, T) and next_pos (B,),
    the first position of generated tokens."""
    ids = np.asarray(input_ids)
    b, t = ids.shape
    pos = np.zeros((3, b, t), np.int64)
    next_pos = np.zeros(b, np.int64)
    for i in range(b):
        spans = sorted(image_spans[i]) if image_spans else []
        cursor = 0
        idx = 0
        for start, gt, gh, gw in spans:
            n_text = start - idx
            if n_text > 0:
                pos[:, i, idx:start] = cursor + np.arange(n_text)
                cursor += n_text
                idx = start
            lh, lw = gh // config_merge, gw // config_merge
            n_img = int(gt) * lh * lw
            tpos = np.repeat(np.arange(int(gt)), lh * lw)
            hpos = np.tile(np.repeat(np.arange(lh), lw), int(gt))
            wpos = np.tile(np.tile(np.arange(lw), lh), int(gt))
            pos[0, i, idx:idx + n_img] = cursor + tpos
            pos[1, i, idx:idx + n_img] = cursor + hpos
            pos[2, i, idx:idx + n_img] = cursor + wpos
            cursor += max(int(gt), lh, lw)
            idx += n_img
        if idx < t:
            pos[:, i, idx:] = cursor + np.arange(t - idx)
            cursor += t - idx
        next_pos[i] = cursor
    return pos, next_pos


def rope_index_batch(input_ids, valid, image_grid_thw, image_token_id, merge=2):
    """3D rope positions for a left- or right-padded batch: per row, strip
    the pad slots, find the contiguous image-token runs (taking grids from
    image_grid_thw in order across the batch, as the processor emits them),
    position the stripped row with text_rope_index and scatter back. Pad
    slots keep position 1 (masked out of attention anyway)."""
    ids = np.asarray(input_ids)
    valid = np.asarray(valid, bool)
    b, t = ids.shape
    pos = np.ones((3, b, t), np.int64)
    next_pos = np.zeros(b, np.int64)
    img_i = 0
    for i in range(b):
        vi = np.nonzero(valid[i])[0]
        sub = ids[i, vi]
        spans = []
        j = 0
        while j < len(sub):
            if sub[j] == image_token_id:
                gt, gh, gw = (int(x) for x in image_grid_thw[img_i])
                img_i += 1
                spans.append((j, gt, gh, gw))
                j += gt * (gh // merge) * (gw // merge)
            else:
                j += 1
        sub_pos, sub_next = text_rope_index(sub[None], [spans], merge)
        pos[:, i, vi] = sub_pos[:, 0]
        next_pos[i] = sub_next[0]
    return pos, next_pos
