"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
MoE on every layer + always-on shared expert (scout layout).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    mlp_act="swiglu",
    moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192, every=1,
                  shared_expert=True),
    use_fsdp=True,
    subquadratic=False,
)
