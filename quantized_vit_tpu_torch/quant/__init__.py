from .packing import pack_int4, unpack_int4

__all__ = ["pack_int4", "unpack_int4"]
