"""The eager core: dtype, place, rng, flags, the Tensor and async steps."""
