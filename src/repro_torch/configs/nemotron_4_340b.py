"""nemotron-4-340b [dense] — GQA + squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
[arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_act="squared_relu",
    use_fsdp=True,               # 340B params cannot fit TP-16 alone
    subquadratic=False,
)
