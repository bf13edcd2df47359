"""The quantize kernel's share of its roofline over the window's complete
swap-outs: each leaf read once, codes and scales written once, at the
card's HBM rate, over the kernel's summed device time, in %."""
from cacs_bench import flops


def read(run):
    return flops.qsnap_roofline(run, r"^qsnap_quantize_kernel$",
                                flops.qsnap_quant_bytes)
