"""granite-8b [dense] — llama-arch code model, GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    mlp_act="swiglu",
    tie_embeddings=True,
    use_fsdp=True,
    subquadratic=False,
)
