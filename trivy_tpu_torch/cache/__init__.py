from trivy_tpu_torch.cache.cache import FSCache, MemoryCache

__all__ = ["FSCache", "MemoryCache"]
