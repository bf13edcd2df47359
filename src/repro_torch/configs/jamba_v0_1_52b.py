"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2
[arXiv:2403.19887; hf]
Layout (per the Jamba paper): blocks of 8 layers with 1 attention + 7 Mamba;
MoE replaces the MLP on every other layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mlp_act="swiglu",
    attn_every=8,                # 1 attention layer per 8 (1:7 with Mamba)
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336, every=2),
    use_fsdp=True,
    subquadratic=True,           # Mamba layers O(1)/token; 4 attn layers KV
)
