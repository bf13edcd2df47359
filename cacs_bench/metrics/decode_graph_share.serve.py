"""Share of the port's ``serve/dispatch`` spans ending in the window whose
decode step replayed a captured CUDA graph (the span's ``graph`` arg), in
% (program span). Nothing is read from a program that never tried to
capture the step: its registry holds neither ``serve.decode_graph_*``
counter of a capture's outcome."""
from cacs_bench import spans

OUTCOMES = ("serve.decode_graph_captures", "serve.decode_graph_fallbacks")


def read(run):
    from repro_torch.obs.telemetry import registry
    if all(registry().get(name) is None for name in OUTCOMES):
        return None
    steps = spans.ending_in(run, "serve/dispatch")
    if not steps:
        return None
    graphed = sum(1 for sp, _, _ in steps if sp.args.get("graph"))
    return 100.0 * graphed / len(steps)
