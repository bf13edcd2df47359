"""The decode-attention kernel's share of its roofline over the window:
for each launch, K and V slots 0..pos read once, q read and the output
written, at the card's HBM rate (its FLOPs bound it less), over the
kernel's summed device time, in %."""
from cacs_bench import flops

PATTERN = r"^decode_kernel$"


def read(run):
    w = run.window
    if w is None or w.t_close is None:
        return None
    import re
    rx = re.compile(PATTERN)
    times = [e - s for n, s, e in w.events if rx.search(n)]
    if not times:
        return None
    B, H, Hkv, hd = run.data["attn"]
    pos0 = run.data["decode_pos0"]
    bw, peak = flops.hbm_peak(run.data["device_kind"]), flops.bf16_peak()
    least = 0.0
    for i in range(len(times)):
        pos = pos0 + i
        least += max(flops.decode_attn_bytes(B, H, Hkv, hd, pos) / bw,
                     4.0 * B * H * hd * (pos + 1) / peak)
    return 100.0 * least / (sum(times) / 1e9)
