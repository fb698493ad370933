"""The busiest expert's rows over the mean expert's, averaged over the MoE
layers and the traced steps (1.0 is an even load), read from the port's
own counters (``runtime/stepstats.counter_totals``: per MoE layer the sum
over steps of the busiest expert's rows, ``<layer>.max_rows``, and of the
T·k assignments, ``<layer>.assignments``; counted only during a capture).
Nothing where the program has no such counters, where they do not cover
exactly the traced steps, or for a model without routed experts
(``n_routed_experts``, DeepSeek-V3's key)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from mpi_operator_tpu_torch.runtime.stepstats import counter_totals
    except ImportError:
        return None
    totals = counter_totals()
    experts = run.cell.config.get("n_routed_experts")
    if totals["steps"] != run.trace.steps or experts is None:
        return None
    counters = totals["counters"]
    ratios = [busiest / (counters[name[:-len("max_rows")] + "assignments"] / experts)
              for name, busiest in counters.items() if name.endswith(".max_rows")]
    return sum(ratios) / len(ratios) if ratios else None
