"""The dequantize kernel's share of its roofline over the window's
complete restores: codes and scales read once, each leaf written once in
its dtype, at the card's HBM rate, over the kernel's summed device time,
in %."""
from cacs_bench import flops


def read(run):
    return flops.qsnap_roofline(run, r"^qsnap_dequantize_kernel$",
                                flops.qsnap_dequant_bytes)
