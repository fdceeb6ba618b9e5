from repro_torch.kernels.linear_scan.ops import (gated_linear_scan,
                                                 gated_linear_scan_bwd_cuda,
                                                 gated_linear_scan_bwd_plain,
                                                 gated_linear_scan_cuda,
                                                 gated_linear_scan_plain,
                                                 scan_config)

__all__ = ["gated_linear_scan", "gated_linear_scan_bwd_cuda",
           "gated_linear_scan_bwd_plain", "gated_linear_scan_cuda",
           "gated_linear_scan_plain", "scan_config"]
