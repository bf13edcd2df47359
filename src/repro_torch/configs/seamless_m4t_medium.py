"""seamless-m4t-medium [audio] — enc-dec multimodal transformer backbone.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf]
The speech frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings consumed by the encoder.
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_act="gelu",
    encoder=EncoderConfig(n_layers=12, n_heads=16, n_kv_heads=16, d_ff=4096),
    frontend="audio_frames",
    frontend_len=4096,           # encoder context length for decode shapes
    subquadratic=False,
)
