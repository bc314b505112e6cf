from .symbols import (
    BUILTINS, is_spl, is_slider_reg, spl_index, slider_index, collect_user_vars,
)
from .funcsl import extract_function_defs, specialize_user_functions
from .analyses import (
    FUNSETS, detect_comm_usage, detect_sample_pool_usage, detect_midi_usage,
    infer_spl_io, validate_builtin_sections, SectionLegalityError,
)
from .program import PluginProgram, compile_plugin_source, load_plugin_file
