"""Distribution utilities: sharding rules, gradient compression."""

from repro_torch.distributed.sharding import named_sharding, sanitize_spec

__all__ = ["named_sharding", "sanitize_spec"]
