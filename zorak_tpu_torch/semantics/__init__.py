from . import scalar
from .scalar import EelRng
