"""flash_attn_tpu: a flash-attention framework in JAX.

Public API surface mirrors the reference flash-attention package
(flash_attn/__init__.py:8-16) — see README.md and SURVEY.md.
"""

__version__ = "0.1.0"

from flash_attn_tpu.interface import (
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_sparse_mla_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
)
from flash_attn_tpu.cache.kvcache import (
    flash_attn_with_kvcache,
    kv_cache_update,
)
from flash_attn_tpu.backend import combine_splits as flash_attn_combine
from flash_attn_tpu.dispatch.scheduler_metadata import get_scheduler_metadata

__all__ = [
    "flash_attn_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_kvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_sparse_mla_func",
    "flash_attn_with_kvcache",
    "flash_attn_combine",
    "kv_cache_update",
    "get_scheduler_metadata",
]
