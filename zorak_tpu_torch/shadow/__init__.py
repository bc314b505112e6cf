from .state import ShadowState, HostServices
from .pyexec import ShadowPlugin, compile_shadow
