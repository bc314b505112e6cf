from .nulltest import (  # noqa: F401
    AUDIO_EPS, SCALAR_EPS, NullReport, apply_slider_state, compare_audio,
    compare_memory_pages, compare_states, make_initialized_shadow,
    null_test_plugin,
)
