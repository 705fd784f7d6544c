from .rangecoder import RangeDecoder, RangeEncoder, update_cdf  # noqa: F401
