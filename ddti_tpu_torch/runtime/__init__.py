from .native import (  # noqa: F401
    NativeBatchLoader,
    NativeSource,
    build_library,
    decode_available,
    decode_jpeg_bytes,
    decode_jpegs,
    native_available,
    write_store,
)
