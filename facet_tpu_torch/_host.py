"""Load jax-free host files of facet_tpu whose package __init__ imports jax.

``facet_tpu/scoring/__init__.py`` imports the vectorized (jax) scorer,
``analyzers/__init__`` the technical analyzer (jax stats) and
``processing/__init__`` the engine, so ``import facet_tpu.scoring.brain``
would pull jax in even though ``brain.py`` itself never imports it. This
helper executes such a file by path, under a private module name, without
running its package ``__init__``. Only the files in ``ALLOWED`` may be
loaded; tests check that each one's own imports are jax-free.
"""

import importlib.util
import os
import sys

_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "facet_tpu")

# name -> file under facet_tpu/
ALLOWED = {
    "brain": "scoring/brain.py",
    "composition": "analyzers/composition.py",
    "metrics_reporter": "processing/metrics_reporter.py",
    "resource_monitor": "processing/resource_monitor.py",
}


def source_path(name):
    return os.path.join(_ROOT, ALLOWED[name])


def load(name):
    """-> the module object for an allow-listed facet_tpu host file."""
    if name not in ALLOWED:
        raise KeyError(f"{name!r} is not an allow-listed host file "
                       f"(allowed: {sorted(ALLOWED)})")
    mod_name = f"facet_tpu_torch._host_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, source_path(name))
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module
