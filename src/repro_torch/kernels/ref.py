"""Plain-torch oracles for every kernel of the port (port of
``repro/kernels/ref.py``).

The attention oracles compute in f32 (the kernels' accumulator dtype)
and cast the output to q's dtype, so tolerances stay tight for bf16
inputs too.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
QSNAP_BLOCK = 256


def _scaled(s: torch.Tensor, hd: int, scale: Optional[float]
            ) -> torch.Tensor:
    """Scores times ``scale``, by default divided by sqrt(hd)."""
    return s / math.sqrt(hd) if scale is None else s * scale


def _flash_mask(S: int, T: int, device, causal: bool,
                window: Optional[int], kv_len: Optional[int]
                ) -> torch.Tensor:
    """[S,T] bool: query row i sees key j (the flash kernels' rule)."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    rel = qp - kp
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    if kv_len is not None:
        mask &= kp < kv_len
    return mask


def _flash_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: Optional[int], kv_len: Optional[int],
                  scale: Optional[float]) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The scaled f32 scores [B,Hkv,g,S,T] of q [B,H,S,hd] against k
    [B,Hkv,T,hd], masked ones ``NEG_INF``, and the mask [S,T]."""
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, S, hd).float()
    s = _scaled(torch.einsum("bkgsd,bktd->bkgst", qg, k.float()), hd, scale)
    mask = _flash_mask(S, T, q.device, causal, window, kv_len)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,Hkv,T,hd] (GQA) -> [B,H,S,hd]; scores scaled
    by ``scale`` (default 1/sqrt(hd))."""
    return flash_attention_lse_ref(q, k, v, causal=causal, window=window,
                                   kv_len=kv_len, scale=scale)[0]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            kv_len: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_ref`` and the softmax's statistic: (out
    [B,H,S,hd] in q's dtype, lse f32 [B,H,S]), ``lse`` each row's
    natural-log log-sum-exp of its scaled scores over the keys it sees
    (-inf for a row that sees none)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    s, mask = _flash_scores(q, k, causal, window, kv_len, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    live = mask.any(dim=-1)                                  # [S]
    lse = torch.where(live, torch.logsumexp(s, dim=-1), -math.inf)
    return (o.reshape(B, H, S, hd).to(q.dtype),
            lse.reshape(B, H, S).float())


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The flash backward's f32 formula. q, o, do: [B,H,S,hd]; k, v:
    [B,Hkv,T,hd]; lse f32 [B,H,S] (``flash_attention_lse_ref``'s) ->
    (dq, dk, dv) in the operands' dtype, of q's, k's and v's shapes:
    p = exp(s - lse) over the visible keys, D = rowsum(do o),
    ds = p (do v^T - D), dq = scale ds k, dk = scale ds^T q (summed over
    the g q-heads of a kv-head), dv = p^T do (likewise)."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    sc = 1.0 / math.sqrt(hd) if scale is None else scale
    s, mask = _flash_scores(q, k, causal, window, None, scale)
    lse_g = lse.reshape(B, Hkv, g, S, 1).float()
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dog = do.reshape(B, Hkv, g, S, hd).float()
    og = o.reshape(B, Hkv, g, S, hd).float()
    dsum = (dog * og).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, v.float())
    ds = p * (dp - dsum)
    dq = sc * torch.einsum("bkgst,bktd->bkgsd", ds, k.float())
    dk = sc * torch.einsum("bkgst,bkgsd->bktd", ds,
                           q.reshape(B, Hkv, g, S, hd).float())
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,hd]; k,v: [B,Hkv,T,hd]; pos scalar -> [B,H,hd].

    Attends over cache slots 0..pos (inclusive).
    """
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = _scaled(torch.einsum("bkgd,bktd->bkgt", qg, k.float()), hd, scale)
    mask = torch.arange(T, device=q.device) <= pos
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, pos,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention_ref`` that also returns the softmax's statistic:
    (out [B,H,hd] in q's dtype, lse f32 [B,H]), ``lse`` the natural-log
    log-sum-exp of the scaled scores over slots 0..pos. What the ranks of
    a context-parallel decode merge (``sharding.specs.merge_attention``).
    ``pos = -1`` is an empty slice: ``out`` is 0 and ``lse`` is -inf."""
    B, H, hd = q.shape
    Hkv = k.shape[1]
    pos = int(pos)
    if pos < 0:
        return (torch.zeros_like(q),
                torch.full((B, H), -math.inf, dtype=torch.float32,
                           device=q.device))
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    s = _scaled(torch.einsum("bkgd,bktd->bkgt", qg,
                             k[:, :, :pos + 1].float()), hd, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,bktd->bkgd", p / den, v[:, :, :pos + 1].float())
    return (o.reshape(B, H, hd).to(q.dtype),
            (m + torch.log(den)).reshape(B, H))


def qsnap_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int8 quantization. x: [N] (N % 256 == 0).

    Returns (codes int8 [N], scales f32 [N/256]). Matches
    ``repro_torch.ckpt.compression.quantize_int8`` bit-for-bit (both sides
    use the absmax * f32(1/127) multiply — see ``compression.INV127``).
    """
    xf = x.float().reshape(-1, QSNAP_BLOCK)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scales = xf.abs().amax(dim=1) * inv127
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(xf / scales[:, None]), -127, 127)
    return codes.to(torch.int8).reshape(-1), scales


def qsnap_dequant_ref(codes: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    blocks = codes.reshape(-1, QSNAP_BLOCK).float()
    return (blocks * scales[:, None]).reshape(-1).to(dtype)
