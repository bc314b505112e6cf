from .registry import FAUST_MODULES, get_faust_module  # noqa: F401
