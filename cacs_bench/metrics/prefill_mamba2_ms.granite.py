"""Device time of the prefill's Mamba-2 blocks: the summed ``device_ms``
of the port's ``prefill/mamba2`` spans (a pair of CUDA events around each
block, read after the prefill's synchronize), in ms (program span).
Nothing is read from a program that records no such span."""


def read(run):
    from repro_torch.obs.trace import tracer
    ms = [sp.args["device_ms"] for sp in tracer().spans(name="prefill/mamba2")
          if "device_ms" in sp.args]
    return sum(ms) if ms else None
