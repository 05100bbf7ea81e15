"""Test-process settings for the port's heavy parity modules.

**One XLA compile per distinct program.**
The reference's steps are jitted anew per session or closure (a train
step's ``loss`` and its inner ``jax.jit``s, every compressed engine's
session, every op of an op-by-op run), so a module that runs the
reference many times compiles the same programs again and again.  Under
:func:`persistent_compile_cache` each program is compiled once and later
compiles of the same program load the executable from a directory of the
test run's temporary files: the same executable, so the same numbers.  The
cache is switched off again when the module ends, so the JAX package's own
test modules run as they always did.

**One torch thread.**  The port's side of these modules runs the plain
versions on tensors of a few thousand values, where torch's intra-op
threads buy nothing; under a parallel test run (one process per core)
every process's thread pool competes for the same cores and each small
op waits on the others.  :func:`one_torch_thread` runs a module on one
thread and gives the process its count back afterwards.

Usage, in a test module::

    from port_test_env import module_compile_cache  # noqa: F401
    from port_test_env import one_torch_thread  # noqa: F401

each of which adds an autouse, module-scoped fixture of that name.
"""
import contextlib

import pytest
import torch

_SETTINGS = {"jax_persistent_cache_min_compile_time_secs": 0.0,
             "jax_persistent_cache_min_entry_size_bytes": -1}


@contextlib.contextmanager
def persistent_compile_cache(path):
    """Compiled programs go to / come from ``path`` inside the block."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache
    saved = {k: getattr(jax.config, k) for k in _SETTINGS}
    saved_dir = jax.config.jax_compilation_cache_dir
    compilation_cache.reset_cache()
    for k, v in _SETTINGS.items():
        jax.config.update(k, v)
    jax.config.update("jax_compilation_cache_dir", str(path))
    try:
        yield
    finally:
        compilation_cache.reset_cache()
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module", autouse=True)
def module_compile_cache(tmp_path_factory):
    """The persistent compile cache over a whole test module, in one
    directory per test process (later modules reuse earlier programs)."""
    path = tmp_path_factory.getbasetemp() / "xla-compile-cache"
    path.mkdir(exist_ok=True)
    with persistent_compile_cache(path):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one torch intra-op thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
