"""granite-4.0-h-small [hybrid] — Mamba-2 + NoPE GQA attention, a dropless
72-expert top-10 MoE on every layer.

40L d_model=4096 vocab=100352, tied embeddings
[huggingface.co/ibm-granite/granite-4.0-h-small, config.json]:
- 36 Mamba-2 mixers: 128 heads of 64, d_state 128, 1 group, conv 4,
  chunk 256, expand 2 (d_inner 8192);
- 4 GQA attention mixers at layers 5, 15, 25, 35 (``attn_offset`` 5 of a
  10-layer period): 32 query heads over 8 kv heads of 128, no positional
  encoding, score scale ``attention_multiplier`` 1/128;
- on every layer 72 SwiGLU experts of width 768, top-10 (softmax over the
  ten chosen logits), dropless, plus a shared SwiGLU MLP of width 1536;
- ``embedding_multiplier`` 12, ``residual_multiplier`` 0.22 on both
  branches of every layer, the logits divided by ``logits_scaling`` 16.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=1536,                   # the shared MLP's (no layer has a dense MLP)
    vocab_size=100352,
    mlp_act="swiglu",
    tie_embeddings=True,
    attn_every=10,
    attn_offset=5,
    use_rope=False,
    attn_scale=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, n_heads=128, head_dim=64,
                  n_groups=1, chunk=256),
    moe=MoEConfig(num_experts=72, top_k=10, d_ff=768, every=1,
                  shared_expert=True, capacity_factor=None),
    use_fsdp=True,
    subquadratic=True,           # Mamba-2 layers O(1)/token; 4 attn layers KV
)
