from .specialize import (
    SpecializeError, SpecializedSampleKernel, specialize_sample_kernel,
)
