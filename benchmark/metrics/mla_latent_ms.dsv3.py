"""Milliseconds per traced step of the latent attention path's forward: on
the device trace, from each ``tpujob_span_mark_mla_in`` mark (which
``models/deepseek_v3.py`` launches before a layer's input norm and
projections) to the next mark when that is ``tpujob_span_mark_mla_attn``
(launched once q, k and v are built, right before K1), summed over the
layers, the forward and the remat's recompute (which launches both again),
over the traced steps. The stretches hold the input norm, the q, latent
down and up projections, the latent's norm, RoPE and k's assembly, idle
included; the backward of that path is not bracketed. Nothing where the
program launches no such marks."""

MLA_IN, MLA_ATTN = "tpujob_span_mark_mla_in", "tpujob_span_mark_mla_attn"


def read(run):
    if run.trace is None or run.unit != "tokens":
        return None
    marks = sorted((s, name) for name, s, _ in run.trace.device
                   if MLA_IN in name or MLA_ATTN in name)
    total_us = sum(b - a for (a, na), (b, nb) in zip(marks, marks[1:])
                   if MLA_IN in na and MLA_ATTN in nb)
    if total_us <= 0:
        return None
    return total_us / 1e3 / run.trace.steps
