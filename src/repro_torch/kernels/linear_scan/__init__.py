from repro_torch.kernels.linear_scan.ops import (gated_linear_scan,
                                                 gated_linear_scan_cuda,
                                                 gated_linear_scan_plain)

__all__ = ["gated_linear_scan", "gated_linear_scan_cuda",
           "gated_linear_scan_plain"]
