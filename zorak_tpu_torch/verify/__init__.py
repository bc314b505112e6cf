from .nulltest import AUDIO_EPS, NullReport, compare_audio  # noqa: F401
