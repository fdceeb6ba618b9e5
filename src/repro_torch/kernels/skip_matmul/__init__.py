from repro_torch.kernels.skip_matmul.ops import (skip_concat_matmul,
                                                 skip_concat_matmul_cuda,
                                                 skip_concat_matmul_plain)

__all__ = ["skip_concat_matmul", "skip_concat_matmul_cuda",
           "skip_concat_matmul_plain"]
