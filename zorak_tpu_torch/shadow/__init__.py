from .state import ShadowState, HostServices
from .pyexec import ShadowPlugin, compile_shadow
from .cgen import NativeShadowPlugin, compile_native_shadow, CGenError
