"""xlstm-125m [ssm] — alternating sLSTM + mLSTM blocks.

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517; unverified]
d_ff=0: xLSTM blocks carry their own up/down projections; no separate FFN.
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, conv_width=4),
    tie_embeddings=True,
    subquadratic=True,           # recurrent: O(1) state per decode step
)
