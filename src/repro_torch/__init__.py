"""repro_torch — the PyTorch/CUDA port of ``repro``.

The module tree mirrors ``src/repro/`` one to one, so every port file
names the reference file it is held against. The port imports ``torch``
and never ``jax``, ``ml_dtypes`` or any module of ``repro``: what it
shares with the reference is the checkpoint image format (MANIFEST v2,
``QS01`` int8 framing, blake2b CAS keys), so an image written by either
package restores in the other.

Entry points (``TrainerApp``, ``ckpt.restore``, ``train.init_state``,
``Model.init``, ``convert.params_from_jax``/``state_from_jax``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
explicit CPU request they raise.
"""
__version__ = "0.1.0"
