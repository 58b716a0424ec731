from trivy_tpu_torch.tensorize.compile import CompiledDB, PackageBatch, compile_db

__all__ = ["CompiledDB", "PackageBatch", "compile_db"]
