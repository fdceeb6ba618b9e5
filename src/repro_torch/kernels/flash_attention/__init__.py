from repro_torch.kernels.flash_attention.ops import (attention_plain,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_route)

__all__ = ["attention_plain", "flash_attention", "flash_attention_cuda",
           "flash_route"]
