"""repro-100m — the end-to-end driver model (examples/train_e2e.py).

~100M-param dense GQA LM used to demonstrate the full CACS-managed training
loop on real (CPU) devices: periodic checkpoints, failure injection, restart,
migration. Analogue of the paper's NAS-LU / dmtcp1 target applications.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab_size=32768,
    mlp_act="swiglu",
    tie_embeddings=True,
    subquadratic=False,
)
