"""Share of the port's training attention calls made with grad enabled
that took the flash kernels (``layers._attend``'s route), in % (program
counter): the registry counters ``attn.train_kernel`` and
``attn.train_ref`` as they stand when the run is read. Nothing is read
from a program without either counter."""

ROUTES = ("attn.train_kernel", "attn.train_ref")


def read(run):
    from repro_torch.obs.telemetry import registry
    kernel, plain = (registry().get(name) for name in ROUTES)
    if kernel is None and plain is None:
        return None
    k = kernel.value if kernel is not None else 0.0
    total = k + (plain.value if plain is not None else 0.0)
    return 100.0 * k / total if total else None
