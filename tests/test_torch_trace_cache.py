"""Every test run traces the JAX package's device sections into a new,
empty directory.

`zorak_tpu/lowering/tracecache.py` keeps traced device steps on disk, in
`ZORAK_TRACE_CACHE_DIR`, and in `~/.cache/zorak_tpu/devgen_traces` when
that is unset.  A step replayed from there never runs the trace-time code
that `tests/test_cond_outline.py` counts (`_n_cond_outlined`), so those
tests pass on a cold cache and fail on a warm one.

pytest imports every test module while it collects, before any test runs,
and each xdist worker collects every module.  So this module, at import,
points `ZORAK_TRACE_CACHE_DIR` at a directory of its own when the caller
has not set one, and removes it when the process exits: the home cache is
then neither read nor written by the run.
"""
import atexit
import os
import shutil
import tempfile

HOME_CACHE = os.path.expanduser("~/.cache/zorak_tpu/devgen_traces")

if not os.environ.get("ZORAK_TRACE_CACHE_DIR"):
    _DIR = tempfile.mkdtemp(prefix="zorak-trace-cache-")
    os.environ["ZORAK_TRACE_CACHE_DIR"] = _DIR
    atexit.register(shutil.rmtree, _DIR, ignore_errors=True)

TRACE_DIR = os.environ["ZORAK_TRACE_CACHE_DIR"]
# the directory's entries when this module was imported, before any test
ENTRIES_AT_IMPORT = (sorted(os.listdir(TRACE_DIR)) if os.path.isdir(TRACE_DIR)
                     else None)


def test_trace_cache_is_a_directory_other_than_the_home_cache():
    assert os.path.isdir(TRACE_DIR)
    assert os.path.realpath(TRACE_DIR) != os.path.realpath(HOME_CACHE)
    assert os.environ["ZORAK_TRACE_CACHE_DIR"] == TRACE_DIR


def test_jax_trace_cache_reads_the_directory():
    from zorak_tpu.lowering import tracecache

    assert os.path.realpath(tracecache.cache_dir()) == \
        os.path.realpath(TRACE_DIR)


def test_trace_cache_was_empty_at_import():
    assert ENTRIES_AT_IMPORT == []
