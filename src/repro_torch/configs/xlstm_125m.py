"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304 — sLSTM + mLSTM blocks
(xLSTM[7:1]-style: sLSTM at every 6th layer), the widths of the JAX
package's ``configs/xlstm_125m.py``.

The recurrent state is O(1) in sequence length; training runs the mLSTM
parallel form (fp32 (B, S, S, H) tensors) and the sLSTM loop over time.
No attention, so no kernel on this path.
"""
import torch

from repro_torch.models.xlstm import XLSTMConfig

CFG = XLSTMConfig(
    name="xlstm-125m", vocab=50304, d_model=768, n_layers=12, n_heads=4,
    slstm_every=6, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
