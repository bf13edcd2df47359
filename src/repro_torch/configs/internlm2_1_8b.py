"""internlm2-1.8b [dense] — GQA decoder LM.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544 [arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    subquadratic=False,
)
