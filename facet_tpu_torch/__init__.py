"""facet_tpu_torch — the PyTorch/CUDA port of facet_tpu for one NVIDIA H100.

The package mirrors ``facet_tpu``'s layout (``ops``, ``models``,
``processing``, ``analyzers``, ``scoring``, ``config``, ``db``, ``utils``)
so every module has a counterpart of the same name. It imports ``torch``
and never ``jax``, ``flax``, ``optax`` or anything of ``facet_tpu``. The JAX
package stays the reference: the tests feed both packages the same numpy
inputs and compare.

Host code is kept as copies: the database layer (``db``), the scoring
config (``config``), the image, EXIF, thumbnail and tag utilities
(``utils``), the scoring brain, the composition analyzer, the metrics
reporter and the RAM monitor are the JAX package's host modules with their
imports pointed at this package (``tests/test_torch_host.py`` holds each
copy against its original). De-duplicating them waits until the JAX package
may change. Every module whose own source imports a JAX module is a port
(colorspace, resize, stats, pHash, CLIP, the aesthetic head, TOPIQ, the
fused pipeline, the technical epilogues, the tagger, the vectorized
aggregate, the engine, the multi-pass processor and burst grouping).

The TPU's Pallas kernels on the ported path are CUDA C++ kernels for
``sm_90a`` (``csrc/``), built at first use by ``ops/cuda_build.py``. On a
CPU tensor each kernel wrapper computes its plain PyTorch twin instead; on
a CUDA tensor it launches the kernel or raises. The entry points run on the
card; the CPU only when the caller asks for it (``--device cpu``,
``device="cpu"``).
"""

__version__ = "0.1.0"
