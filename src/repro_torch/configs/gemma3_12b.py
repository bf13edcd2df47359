"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]

5/6 of layers use a 1024-token sliding window, so per-token decode work at
500k context is dominated by the window — we treat the arch as effectively
sub-quadratic and run long_500k (global layers pay full KV; see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    mlp_act="swiglu",
    attn_pattern="local_global",
    local_window=1024,
    local_global_ratio=5,        # 5 local : 1 global
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    use_fsdp=True,
    subquadratic=True,
)
