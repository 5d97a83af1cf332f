"""Where the program runs: the kernel target and the compile cache.

Kernels (`ops/lanewise.py`) are built with nvcc for an NVIDIA GPU.  On the
CPU the same generated source is built with the host C++ compiler (what
the tests run at small sizes).  Nothing else is supported.
"""

import os

import jax

__all__ = ["kernel_platform", "setup_compile_cache", "REPO_ROOT"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def kernel_platform() -> str:
    """The kernel build target of JAX's default backend: "cuda" on the GPU,
    "cpu" on the CPU (a host build of the same source).  Raises on any
    other backend."""
    backend = jax.default_backend()
    if backend == "gpu":
        return "cuda"
    if backend == "cpu":
        return "cpu"
    raise RuntimeError(f"no kernel target for the {backend!r} backend "
                       "(supported: gpu, and cpu for tests)")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it
    itself); otherwise the cache lives at ``<repo>/.jax_cache`` — a fixed
    path, because the path is part of the cache key.  Returns the
    directory in use."""
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return cache
