"""facet_tpu_torch — the PyTorch/CUDA port of facet_tpu for one NVIDIA H100.

The package mirrors ``facet_tpu``'s layout (``ops``, ``models``,
``processing``, ``analyzers``, ``scoring``, ``utils``) so every module has a
counterpart of the same name. It imports ``torch`` and never ``jax``,
``flax`` or ``optax`` — not even through ``facet_tpu``. The JAX package stays
the reference: the tests feed both packages the same numpy inputs and compare.

Host code is reached three ways:

1. **Plain import** for ``facet_tpu`` modules whose whole import chain is
   jax-free: ``facet_tpu.db.*``, ``facet_tpu.config.*`` and
   ``facet_tpu.utils.{image_loading,exif,thumbnails,native_decode,tags}``.
2. **The loader helper** (``facet_tpu_torch._host.load``) for files whose
   own source is jax-free but whose package ``__init__`` imports jax:
   ``scoring/brain.py``, ``analyzers/composition.py``,
   ``processing/metrics_reporter.py`` and ``processing/resource_monitor.py``.
   The helper runs the file by path under a private module name, so scoring
   semantics keep one source of truth.
3. **A port** for every module whose own source imports a JAX module
   (colorspace, resize, stats, pHash, CLIP, the aesthetic head, TOPIQ, the
   fused pipeline, the technical epilogues, the tagger, the vectorized
   aggregate, the engine, the multi-pass processor and burst grouping).

The TPU's two main-path Pallas kernels are CUDA C++ kernels for ``sm_90a``
(``csrc/``), built at first use by ``ops/cuda_build.py``. On a CPU tensor
each kernel wrapper computes its plain PyTorch twin instead; on a CUDA
tensor it launches the kernel or raises.

``FACET_PLATFORM`` must stay unset for this package: ``facet_tpu/__init__``
imports jax when it is set.
"""

__version__ = "0.1.0"
