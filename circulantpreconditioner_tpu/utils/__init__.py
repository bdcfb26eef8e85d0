from circulantpreconditioner_tpu.utils.compile_cache import (  # noqa: F401
    enable_compile_cache,
)
