"""Model lifecycle: loading, device-memory budgeting, pass planning and the
host-RAM parameter cache.

Counterpart of ``facet_tpu/models/model_manager.py``. It runs on the card
unless the caller asks for the CPU (``device="cpu"``), and raises when
there is no usable card. Device memory comes from
``torch.cuda.mem_get_info`` (total memory of the card), or host RAM in CPU
mode; pass grouping is the same first-fit-decreasing bin packing over
that budget. Factories are registered for ``clip``, ``topiq``, ``samp_net``,
``insightface`` and the three taggers of the fallback chain: ``vlm_tagger``
(Qwen2.5-VL-7B on the card), and ``qwen3_vl_tagger`` and ``ram_tagger``,
which only run the JAX package's availability probes (the port does not
run them yet). Any other member of the JAX package's ensemble raises
``NotImplementedError`` naming the ROADMAP entry it waits in. ``probe``
tells, without loading anything, whether a member would load.
"""

import os

import torch

# Footprints in GB of the ported models: device memory (params + activation
# headroom) and host RAM in CPU mode, as the JAX package budgets them.
MODEL_DEVICE_REQUIREMENTS = {"clip": 2.0, "topiq": 1.5, "samp_net": 0.6,
                             "insightface": 0.8, "vlm_tagger": 18.0,
                             "qwen3_vl_tagger": 7.0, "ram_tagger": 14.0}
MODEL_RAM_REQUIREMENTS = {"clip": 3.0, "topiq": 2.0, "samp_net": 1.0,
                          "insightface": 1.2, "vlm_tagger": 30.0,
                          "qwen3_vl_tagger": 9.0, "ram_tagger": 16.0}

QUALITY_MODEL_ALIASES = {
    "topiq": "topiq", "hyperiqa": "hyperiqa", "dbcnn": "dbcnn", "musiq": "musiq",
    "musiq-koniq": "musiq", "clipiqa": "clipiqa", "clipiqa+": "clipiqa",
    "clip-iqa+": "clipiqa",
}

# Members of the JAX package's ensemble that this port does not run yet ->
# where ROADMAP.md queues them.
UNPORTED = {
    "clipiqa": "Queue 1 #9.2 (CLIP-IQA+)",
    "hyperiqa": "Queue 1 #9.2 (HyperIQA)",
    "dbcnn": "Queue 1 #9.2 (DBCNN)",
    "musiq": "Queue 1 #9.2 (MUSIQ)",
}


def resolve_device(device=None):
    """The device the port runs on: the card, unless the caller asks for the
    CPU. A missing or unusable card is an error, never a quiet CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "facet_tpu_torch runs on an NVIDIA GPU, and no usable CUDA card was "
            "found (torch.cuda.is_available() is false); to run on the CPU, "
            "ask for it: --device cpu on the command line, device='cpu' in code")
    return device


def detect_device_memory_gb(device):
    """Total memory of the card in GB, or 0.0 in CPU mode."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    _, total = torch.cuda.mem_get_info(device)
    return total / (1024 ** 3)


def detect_ram_gb():
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / (1024 ** 3)
    except (ValueError, OSError, AttributeError):
        return 8.0


class ModelManager:
    """Loads/unloads ensemble members against a device-memory budget."""

    def __init__(self, config=None, device=None, memory_gb=None):
        self.config = config
        self.device = resolve_device(device)
        self.memory_gb = (detect_device_memory_gb(self.device) if memory_gb is None
                          else memory_gb)
        self.loaded = {}
        self._host_cache = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._factories = {}
        self._probes = {}
        self._register_default_factories()

    def register(self, name, factory):
        """factory(config, host_params_or_None) -> model object with optional
        .host_params() for RAM caching. A registered factory replaces the
        default one and its probe."""
        self._factories[name] = factory
        self._probes.pop(name, None)

    def probe(self, name):
        """Whether ``load_model(name)`` would load, checked without loading:
        False when the member is not installed (its loader would raise
        RuntimeError and the fallback chain go on); NotImplementedError
        when it is installed in a form the port does not run yet. A member
        without a probe (a registered factory, a ported model) is True."""
        if name not in self._probes:
            return name in self._factories
        try:
            self._probes[name](self.config)
        except NotImplementedError:      # a RuntimeError, and not "absent"
            raise
        except RuntimeError:
            return False
        return True

    def _register_default_factories(self):
        device = self.device

        def make_clip(config, cached):
            from facet_tpu_torch.models.aesthetic import AestheticScorer

            return AestheticScorer.create(config, cached, device)

        def make_topiq(config, cached):
            from facet_tpu_torch.models.topiq import TOPIQScorer

            return TOPIQScorer.create(config, cached, device)

        def make_samp(config, cached):
            from facet_tpu_torch.models.samp_net import SAMPComposition

            return SAMPComposition.create(config, cached, device)

        def make_insightface(config, cached):
            from facet_tpu_torch.models.face_pipeline import FacePipeline

            return FacePipeline.create(config, cached, device)

        def qwen_tagger(model_name):
            def make(config, cached):
                from facet_tpu_torch.models.vlm_tagger import VLMTagger

                tagger = VLMTagger(config, model_name=model_name, device=device)
                tagger.ensure_loaded()    # raises when the weights are absent
                return tagger

            def probe(config):
                from facet_tpu_torch.models.vlm_tagger import VLMTagger

                return VLMTagger(config, model_name=model_name, device=device).probe()

            return make, probe

        def probe_ram(config):
            from facet_tpu_torch.models.vlm_tagger import probe_ram

            probe_ram(config)     # always raises: the port does not run RAM++

        self._factories["clip"] = make_clip
        self._factories["topiq"] = make_topiq
        self._factories["samp_net"] = make_samp
        self._factories["insightface"] = make_insightface
        for name, model_name in (("vlm_tagger", "qwen2.5-vl-7b"),
                                 ("qwen3_vl_tagger", "qwen3-vl-2b")):
            self._factories[name], self._probes[name] = qwen_tagger(model_name)
        self._factories["ram_tagger"] = lambda config, cached: probe_ram(config)
        self._probes["ram_tagger"] = probe_ram

    def load_model(self, name):
        if name in self.loaded:
            return self.loaded[name]
        if name in UNPORTED:
            raise NotImplementedError(
                f"model '{name}' is not ported to facet_tpu_torch yet "
                f"(ROADMAP.md {UNPORTED[name]})")
        if name not in self._factories:
            raise KeyError(f"unknown model '{name}' (known: {sorted(self._factories)})")
        cached = self._host_cache.get(name)
        if cached is not None:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        model = self._factories[name](self.config, cached)
        self.loaded[name] = model
        return model

    def unload_model(self, name):
        """Drop the device copy; keep params in host RAM for a fast reload."""
        model = self.loaded.pop(name, None)
        if model is None:
            return
        host_params = getattr(model, "host_params", None)
        if callable(host_params):
            self._host_cache[name] = host_params()
        del model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def evict_host_cache(self):
        """Drop the host-RAM parameter cache (the RAM monitor calls this
        under memory pressure)."""
        self._host_cache.clear()

    def cache_stats(self):
        total = self.cache_hits + self.cache_misses
        return {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "hit_rate": self.cache_hits / total if total else 0.0,
            "cached_models": sorted(self._host_cache),
        }

    # -------------------------------------------------------- pass planning

    def capacity_gb(self):
        """Usable budget: device memory - 1 GB headroom, or RAM - 2 GB."""
        if self.memory_gb > 0:
            return max(1.0, self.memory_gb - 1.0)
        return max(1.0, detect_ram_gb() - 2.0)

    def requirements(self, name):
        table = MODEL_DEVICE_REQUIREMENTS if self.memory_gb > 0 else MODEL_RAM_REQUIREMENTS
        return table.get(name, 1.0)

    def group_passes(self, model_names):
        """First-fit-decreasing bin packing of models into device passes."""
        capacity = self.capacity_gb()
        ordered = sorted(model_names, key=self.requirements, reverse=True)
        passes, loads = [], []
        for name in ordered:
            need = self.requirements(name)
            for i, load in enumerate(loads):
                if load + need <= capacity:
                    passes[i].append(name)
                    loads[i] += need
                    break
            else:
                passes.append([name])
                loads.append(need)
        return passes

    def select_models(self, config=None):
        """The JAX package's ensemble for the configured profile, unfiltered:
        the CLI refuses a scan that would need an unported member."""
        config = config or self.config
        models = ["clip"]
        if config is not None:
            quality = QUALITY_MODEL_ALIASES.get(config.get_model_for_task("aesthetic"))
            if quality:
                models.append(quality)
            if config.is_using_samp_net():
                models.append("samp_net")
            tagging = config.get_model_for_task("tagging")
            if tagging == "qwen2.5-vl-7b":
                models.append("vlm_tagger")
            elif tagging == "qwen3-vl-2b":
                models.append("qwen3_vl_tagger")
        models.append("insightface")
        return list(dict.fromkeys(models))

    def unported(self, names):
        return [m for m in names if m not in self._factories]
