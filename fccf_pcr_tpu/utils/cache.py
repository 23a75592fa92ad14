"""Where JAX's persistent compilation cache lives.

Every entry point (chip_smoke.py, bench.py, the CLI, tools/evaluate.py,
tools/warm_cache.py, the test suite) calls :func:`setup_compile_cache`:

  - if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    module sets nothing;
  - otherwise the cache is ``<checkout>/.jax_cache/`` (listed in
    .gitignore). The path is fixed because it is part of the cache key: a
    directory that moves never hits.

On the CPU backend the cache goes one level deeper, into a subdirectory
named by a host fingerprint. XLA:CPU's cache is keyed by program only, not
by the host's CPU: an executable compiled ahead of time on one host can
load on another with other vector features, where it risks SIGILL and
computes f32 reductions in another order than a fresh compile would
(observed: scores shifted ~4e-3 relative, tripping the golden bands).
Keying by host makes such entries unreachable instead of subtly wrong.
"""

from __future__ import annotations

import hashlib
import os
import platform
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def host_fingerprint() -> str:
    """Hash of (machine, CPU model/stepping/microcode/flags, python,
    jax/jaxlib versions).

    The CPU *model* counts, not just its feature flags: LLVM derives tuning
    features (e.g. ``prefer-no-gather`` on Downfall-mitigated Intel parts)
    from the model, so two hosts with identical ``flags`` can still compile
    incompatible executables."""
    ident = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(
                    ("flags", "model name", "model\t", "stepping", "microcode")
                ):
                    ident.append(line.strip())
                if line.startswith("power management"):  # end of first CPU
                    break
    except OSError:
        pass
    import jax
    import jaxlib

    key = "|".join([
        platform.machine(), platform.python_version(),
        jax.__version__, jaxlib.__version__, *ident,
    ])
    return hashlib.sha1(key.encode()).hexdigest()[:10]


def compile_cache_dir(backend: str, environ=os.environ) -> Path | None:
    """The directory this module would set for ``backend``, or None when
    ``JAX_COMPILATION_CACHE_DIR`` already places the cache."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if backend == "cpu":
        return DEFAULT_DIR / f"cpu-{host_fingerprint()}"
    return DEFAULT_DIR


def setup_compile_cache() -> str:
    """Place the persistent compilation cache (see the module docstring)
    for the default backend and return the directory in use. Call it once
    the platform is chosen."""
    import jax

    path = compile_cache_dir(jax.default_backend())
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)
