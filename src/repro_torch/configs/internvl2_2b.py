"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2-1.8b backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821; hf]
The ViT frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (256 tokens) prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    frontend="vit_patches",
    frontend_len=256,
    subquadratic=False,
)
